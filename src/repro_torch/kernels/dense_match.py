"""Streaming dense matching kernel (counterpart of ``repro/kernels/dense_match.py``).

:func:`dense_match_stream` replaces ``dense_match_stream_pallas``: on CUDA
tensors it launches the hand-written kernel in
``csrc/dense_match_stream.cu`` (one launch for both views of a whole
frame); on CPU tensors it runs the plain version,
:func:`repro_torch.kernels.ref.dense_match_rows_stream_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

# Number of kernel launches since the last reset (CPU calls do not count).
launches = 0


# ielas_dense_match_stream(desc_l, desc_r, mu_l, mu_r, gmask_l, gmask_r, out_l,
#     out_r, h, w, cw, num_disp, disp_min, plane_radius, cell_px, beta, gamma,
#     two_s2, match_texture, stream)
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float] * 3 + [
    ctypes.c_int, ctypes.c_void_p,
]


@functools.cache
def _kernel():
    fn = _build.load("dense_match_stream").ielas_dense_match_stream
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def dense_match_stream(
    desc_l: torch.Tensor,       # (H, W, 16) int8
    desc_r: torch.Tensor,       # (H, W, 16) int8
    mu_l: torch.Tensor,         # (H, W) float32
    mu_r: torch.Tensor,         # (H, W) float32
    gmask_l: torch.Tensor,      # (H, CW, D) bool grid-vector bitmask rows
    gmask_r: torch.Tensor,      # (H, CW, D) bool
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
    """(disp_l, disp_r), each (H, W) float32 with INVALID = -1."""
    if desc_l.dim() != 3 or desc_l.shape[-1] != 16 or desc_r.shape != desc_l.shape:
        raise ValueError(
            f"descriptors must be two (H, W, 16), got {tuple(desc_l.shape)}, {tuple(desc_r.shape)}"
        )
    h, w, _ = desc_l.shape
    if mu_l.shape != (h, w) or mu_r.shape != (h, w):
        raise ValueError(f"priors must be (H, W) = {(h, w)}")
    if gmask_l.dim() != 3 or gmask_l.shape[0] != h or gmask_l.shape[2] != num_disp \
            or gmask_r.shape != gmask_l.shape or gmask_l.shape[1] < 1:
        raise ValueError(f"bitmasks must be (H, CW, D) = ({h}, CW, {num_disp})")
    if desc_l.dtype != torch.int8 or desc_r.dtype != torch.int8:
        raise TypeError("descriptors must be int8")
    if mu_l.dtype != torch.float32 or mu_r.dtype != torch.float32:
        raise TypeError("priors must be float32")
    if gmask_l.dtype != torch.bool or gmask_r.dtype != torch.bool:
        raise TypeError("bitmasks must be bool")
    if num_disp < 1 or disp_min < 0 or plane_radius < 0 or cell_px < 1:
        raise ValueError(
            f"bad search geometry: num_disp={num_disp} disp_min={disp_min} "
            f"plane_radius={plane_radius} cell_px={cell_px}"
        )
    inputs = (desc_l, desc_r, mu_l, mu_r, gmask_l, gmask_r)
    device = desc_l.device
    if any(t.device != device for t in inputs):
        raise ValueError("all inputs must be on one device")
    kwargs = dict(
        num_disp=num_disp, disp_min=disp_min, plane_radius=plane_radius, cell_px=cell_px,
        beta=beta, gamma=gamma, sigma=sigma, match_texture=match_texture,
    )
    if device.type == "cpu":
        return ref.dense_match_rows_stream_ref(*inputs, **kwargs)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if (not all(t.is_contiguous() for t in inputs)
            or desc_l.data_ptr() % 16 or desc_r.data_ptr() % 16):
        raise ValueError("inputs must be contiguous, descriptors 16-byte aligned")
    out_l = torch.empty((h, w), dtype=torch.float32, device=device)
    out_r = torch.empty((h, w), dtype=torch.float32, device=device)
    if out_l.numel() == 0:
        return out_l, out_r
    fn = _kernel()
    with torch.cuda.device(device):
        err = fn(
            *(t.data_ptr() for t in (*inputs, out_l, out_r)),
            h, w, gmask_l.shape[1], num_disp, disp_min, plane_radius, cell_px,
            beta, gamma, 2.0 * sigma * sigma, match_texture,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"dense_match_stream kernel launch failed: cudaError_t {err}")
    global launches
    launches += 1
    return out_l, out_r
