"""Dense matching kernels (counterpart of ``repro/kernels/dense_match.py``).

* :func:`dense_match_stream` replaces ``dense_match_stream_pallas``: the
  gather-free scan over d, with the candidate set as grid-vector bitmasks
  OR the plane-prior band; the kernel is ``csrc/dense_match_stream.cu``,
  the plain version :func:`repro_torch.kernels.ref.dense_match_rows_stream_ref`.
* :func:`dense_match_candidates` replaces ``dense_match_pallas``: the energy
  over a per-pixel candidate tensor (the paper's C = K + 2R + 1 window); the
  kernel is ``csrc/dense_match_windowed.cu``, the plain version
  :func:`repro_torch.kernels.ref.dense_match_rows_windowed_ref`.
* :func:`dense_match_warm` replaces the reference's XLA warm-start scan
  (``dense_match_warm_xla``): only the band around a previous frame's
  disparity; the kernel is ``csrc/dense_match_warm.cu``, the plain version
  :func:`repro_torch.kernels.ref.dense_match_rows_warm_ref`.

On CUDA tensors each launches its kernel once for both views of a frame,
or of every frame of a wave (a leading batch axis); on CPU tensors it runs
the plain version.  :func:`xla_exp_log` evaluates the kernels' float32 exp
and log on the card, and :func:`warm_reciprocal` the warm kernel's
reciprocal, so they can be held against the plain helpers and a division.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

# Number of launches of each kernel since the last reset (CPU calls do not
# count): the streaming kernel's, the candidate-window kernel's, and the
# warm band kernel's.
launches = 0
windowed_launches = 0
warm_launches = 0

# The stream kernel stages a tile's descriptor columns and packed bitmask
# words for up to this many disparities in shared memory, and tests the
# prior band on integers, exact for the in-image d < W <= 2**24.
# dense_match_stream raises beyond either limit on every device, so the CPU
# and the card take the same inputs.
STREAM_MAX_DISP = 1024
STREAM_MAX_WIDTH = 1 << 24


# ielas_dense_match_stream(desc_l, desc_r, mu_l, mu_r, gmask_l, gmask_r, out_l,
#     out_r, batch, h, w, cw, num_disp, disp_min, plane_radius, cell_px, beta,
#     gamma, two_s2, match_texture, stream)
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float] * 3 + [
    ctypes.c_int, ctypes.c_void_p,
]
# ielas_dense_match_windowed(desc_l, desc_r, mu_l, mu_r, cand_l, cand_r, out_l,
#     out_r, batch, h, w, c, num_disp, disp_min, beta, gamma, two_s2,
#     match_texture, stream)
WINDOWED_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + [
    ctypes.c_int, ctypes.c_void_p,
]
# ielas_dense_match_warm(desc_l, desc_r, mu_l, mu_r, out_l, out_r, batch, h, w,
#     num_disp, disp_min, band, beta, inv_2s2, match_texture, stream)
WARM_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [
    ctypes.c_int, ctypes.c_void_p,
]
# The warm kernel tests its band on integers, exact while the search range's
# last disparity is below 2**24; dense_match_warm raises beyond it on every
# device.
WARM_MAX_DISP = 1 << 24
# ielas_xla_exp_log(x, ex, lg, n, stream)
EXP_LOG_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
# ielas_warm_reciprocal(q, out, n, stream)
WARM_RECIPROCAL_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p]


@functools.cache
def _kernel():
    return _build.bind("dense_match_stream", "ielas_dense_match_stream", ARGTYPES)


@functools.cache
def _windowed_kernel():
    return _build.bind("dense_match_windowed", "ielas_dense_match_windowed", WINDOWED_ARGTYPES)


@functools.cache
def _warm_kernel():
    return _build.bind("dense_match_warm", "ielas_dense_match_warm", WARM_ARGTYPES)


@functools.cache
def _warm_reciprocal_kernel():
    return _build.bind("dense_match_warm", "ielas_warm_reciprocal", WARM_RECIPROCAL_ARGTYPES)


@functools.cache
def _exp_log_kernel():
    return _build.bind("dense_match_stream", "ielas_xla_exp_log", EXP_LOG_ARGTYPES)


def _check_common(desc_l, desc_r, mu_l, mu_r, num_disp, disp_min):
    """Shape and type checks shared by both dense kernels; returns
    (leading batch dims, H, W)."""
    if desc_l.dim() not in (3, 4) or desc_l.shape[-1] != 16 or desc_r.shape != desc_l.shape:
        raise ValueError(
            f"descriptors must be two ([B,] H, W, 16), got {tuple(desc_l.shape)}, "
            f"{tuple(desc_r.shape)}"
        )
    *lead, h, w, _ = desc_l.shape
    if mu_l.shape != (*lead, h, w) or mu_r.shape != mu_l.shape:
        raise ValueError(f"priors must be ([B,] H, W) = {(*lead, h, w)}")
    if desc_l.dtype != torch.int8 or desc_r.dtype != torch.int8:
        raise TypeError("descriptors must be int8")
    if mu_l.dtype != torch.float32 or mu_r.dtype != torch.float32:
        raise TypeError("priors must be float32")
    if num_disp < 1 or disp_min < 0:
        raise ValueError(f"bad search range: num_disp={num_disp} disp_min={disp_min}")
    return lead, h, w


def _device_of(inputs) -> torch.device:
    device = inputs[0].device
    if any(t.device != device for t in inputs):
        raise ValueError("all inputs must be on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and (
        not all(t.is_contiguous() for t in inputs)
        or inputs[0].data_ptr() % 16 or inputs[1].data_ptr() % 16
    ):
        raise ValueError("inputs must be contiguous, descriptors 16-byte aligned")
    return device


def dense_match_stream(
    desc_l: torch.Tensor,       # ([B,] H, W, 16) int8
    desc_r: torch.Tensor,       # ([B,] H, W, 16) int8
    mu_l: torch.Tensor,         # ([B,] H, W) float32
    mu_r: torch.Tensor,         # ([B,] H, W) float32
    gmask_l: torch.Tensor,      # ([B,] H, CW, D) bool grid-vector bitmask rows
    gmask_r: torch.Tensor,      # ([B,] H, CW, D) bool
    *,
    num_disp: int,
    disp_min: int,
    plane_radius: int,
    cell_px: int,
    beta: float,
    gamma: float,
    sigma: float,
    match_texture: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(disp_l, disp_r), each ([B,] H, W) float32 with INVALID = -1."""
    lead, h, w = _check_common(desc_l, desc_r, mu_l, mu_r, num_disp, disp_min)
    if gmask_l.dim() != len(lead) + 3 or gmask_l.shape[: len(lead) + 1] != (*lead, h) \
            or gmask_l.shape[-1] != num_disp or gmask_r.shape != gmask_l.shape \
            or gmask_l.shape[-2] < 1:
        raise ValueError(f"bitmasks must be ([B,] H, CW, D) = ({(*lead, h)}, CW, {num_disp})")
    if gmask_l.dtype != torch.bool or gmask_r.dtype != torch.bool:
        raise TypeError("bitmasks must be bool")
    if plane_radius < 0 or cell_px < 1:
        raise ValueError(f"bad candidate geometry: plane_radius={plane_radius} cell_px={cell_px}")
    if num_disp > STREAM_MAX_DISP or w > STREAM_MAX_WIDTH:
        raise ValueError(f"the stream kernel takes num_disp <= {STREAM_MAX_DISP} and width <= "
                         f"{STREAM_MAX_WIDTH}, got num_disp={num_disp}, width={w}")
    inputs = (desc_l, desc_r, mu_l, mu_r, gmask_l, gmask_r)
    device = _device_of(inputs)
    batch = lead[0] if lead else 1
    kwargs = dict(
        num_disp=num_disp, disp_min=disp_min, plane_radius=plane_radius, cell_px=cell_px,
        beta=beta, gamma=gamma, sigma=sigma, match_texture=match_texture,
    )
    if device.type == "cpu":
        n = batch * h
        out = ref.dense_match_rows_stream_ref(
            desc_l.reshape(n, w, 16), desc_r.reshape(n, w, 16),
            mu_l.reshape(n, w), mu_r.reshape(n, w),
            gmask_l.reshape(n, -1, num_disp), gmask_r.reshape(n, -1, num_disp), **kwargs,
        )
        return tuple(o.reshape(*lead, h, w) for o in out)
    out_l = torch.empty((*lead, h, w), dtype=torch.float32, device=device)
    out_r = torch.empty_like(out_l)
    if out_l.numel() == 0:
        return out_l, out_r
    fn = _kernel()
    with torch.cuda.device(device):
        err = fn(
            *(t.data_ptr() for t in (*inputs, out_l, out_r)),
            batch, h, w, gmask_l.shape[-2], num_disp, disp_min, plane_radius, cell_px,
            beta, gamma, 2.0 * sigma * sigma, match_texture,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"dense_match_stream kernel launch failed: cudaError_t {err}")
    global launches
    launches += 1
    return out_l, out_r


def dense_match_candidates(
    desc_l: torch.Tensor,       # ([B,] H, W, 16) int8
    desc_r: torch.Tensor,       # ([B,] H, W, 16) int8
    mu_l: torch.Tensor,         # ([B,] H, W) float32
    mu_r: torch.Tensor,         # ([B,] H, W) float32
    cand_l: torch.Tensor,       # ([B,] H, W, C) int32 candidate disparities
    cand_r: torch.Tensor,       # ([B,] H, W, C) int32
    *,
    num_disp: int,
    disp_min: int,
    beta: float,
    gamma: float,
    sigma: float,
    match_texture: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(disp_l, disp_r), each ([B,] H, W) float32 with INVALID = -1: the
    minimum-energy candidate of each pixel (the smallest value on ties)."""
    lead, h, w = _check_common(desc_l, desc_r, mu_l, mu_r, num_disp, disp_min)
    if cand_l.dim() != len(lead) + 3 or cand_l.shape[:-1] != (*lead, h, w) \
            or cand_r.shape != cand_l.shape or cand_l.shape[-1] < 1:
        raise ValueError(f"candidates must be ([B,] H, W, C) = ({(*lead, h, w)}, C)")
    if cand_l.dtype != torch.int32 or cand_r.dtype != torch.int32:
        raise TypeError("candidates must be int32")
    inputs = (desc_l, desc_r, mu_l, mu_r, cand_l, cand_r)
    device = _device_of(inputs)
    batch = lead[0] if lead else 1
    c = cand_l.shape[-1]
    kwargs = dict(num_disp=num_disp, disp_min=disp_min, beta=beta, gamma=gamma, sigma=sigma,
                  match_texture=match_texture)
    if device.type == "cpu":
        n = batch * h
        out = ref.dense_match_rows_windowed_ref(
            desc_l.reshape(n, w, 16), desc_r.reshape(n, w, 16),
            mu_l.reshape(n, w), mu_r.reshape(n, w),
            cand_l.reshape(n, w, c), cand_r.reshape(n, w, c), **kwargs,
        )
        return tuple(o.reshape(*lead, h, w) for o in out)
    out_l = torch.empty((*lead, h, w), dtype=torch.float32, device=device)
    out_r = torch.empty_like(out_l)
    if out_l.numel() == 0:
        return out_l, out_r
    fn = _windowed_kernel()
    with torch.cuda.device(device):
        err = fn(
            *(t.data_ptr() for t in (*inputs, out_l, out_r)),
            batch, h, w, c, num_disp, disp_min, beta, gamma, 2.0 * sigma * sigma,
            match_texture, torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"dense_match_windowed kernel launch failed: cudaError_t {err}")
    global windowed_launches
    windowed_launches += 1
    return out_l, out_r


def dense_match_warm(
    desc_l: torch.Tensor,       # ([B,] H, W, 16) int8
    desc_r: torch.Tensor,       # ([B,] H, W, 16) int8
    mu_l: torch.Tensor,         # ([B,] H, W) float32 warm prior
    mu_r: torch.Tensor,         # ([B,] H, W) float32
    *,
    num_disp: int,
    disp_min: int,
    warm_band: int,
    beta: float,
    sigma: float,
    match_texture: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(disp_l, disp_r), each ([B,] H, W) float32 with INVALID = -1: the
    least-energy candidate of each pixel's band ``round(mu) -/+ warm_band``
    (clipped to the search range and the image), the smallest on ties."""
    lead, h, w = _check_common(desc_l, desc_r, mu_l, mu_r, num_disp, disp_min)
    if warm_band < 0:
        raise ValueError(f"warm_band must be >= 0, got {warm_band}")
    if disp_min + num_disp > WARM_MAX_DISP or warm_band >= WARM_MAX_DISP:
        raise ValueError(f"the warm kernel takes disp_min + num_disp and warm_band below "
                         f"{WARM_MAX_DISP}, got {disp_min} + {num_disp} and {warm_band}")
    inputs = (desc_l, desc_r, mu_l, mu_r)
    device = _device_of(inputs)
    batch = lead[0] if lead else 1
    kwargs = dict(num_disp=num_disp, disp_min=disp_min, warm_band=warm_band, beta=beta,
                  sigma=sigma, match_texture=match_texture)
    if device.type == "cpu":
        n = batch * h
        out = ref.dense_match_rows_warm_ref(
            desc_l.reshape(n, w, 16), desc_r.reshape(n, w, 16),
            mu_l.reshape(n, w), mu_r.reshape(n, w), **kwargs,
        )
        return tuple(o.reshape(*lead, h, w) for o in out)
    out_l = torch.empty((*lead, h, w), dtype=torch.float32, device=device)
    out_r = torch.empty_like(out_l)
    if out_l.numel() == 0:
        return out_l, out_r
    fn = _warm_kernel()
    with torch.cuda.device(device):
        err = fn(
            *(t.data_ptr() for t in (*inputs, out_l, out_r)),
            batch, h, w, num_disp, disp_min, warm_band, beta, 1.0 / (2.0 * sigma * sigma),
            match_texture, torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"dense_match_warm kernel launch failed: cudaError_t {err}")
    global warm_launches
    warm_launches += 1
    return out_l, out_r


def xla_exp_log(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense kernels' float32 (exp(x), log(x)) for a float32 tensor on
    the card (log only meaningful for positive normal x).  No plain
    version: on the CPU the same functions are ``ref.xla_exp_f32`` and
    ``ref.xla_log_f32``."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("xla_exp_log takes a float32 CUDA tensor")
    x = x.contiguous()
    ex, lg = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            err = _exp_log_kernel()(x.data_ptr(), ex.data_ptr(), lg.data_ptr(), x.numel(),
                                    torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"xla_exp_log kernel launch failed: cudaError_t {err}")
    return ex, lg


def warm_reciprocal(q: torch.Tensor) -> torch.Tensor:
    """The warm kernel's reciprocal 1 / q (rcp.approx and one Newton step) for
    a float32 tensor on the card, meaningful for q in [1, 2**126), where the
    kernel uses it and it must equal a correctly rounded division.  No plain
    version: on the CPU the kernel's prior divides."""
    if q.device.type != "cuda" or q.dtype != torch.float32:
        raise ValueError("warm_reciprocal takes a float32 CUDA tensor")
    q = q.contiguous()
    out = torch.empty_like(q)
    if q.numel():
        with torch.cuda.device(q.device):
            err = _warm_reciprocal_kernel()(q.data_ptr(), out.data_ptr(), q.numel(),
                                            torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"warm_reciprocal kernel launch failed: cudaError_t {err}")
    return out
