"""Support-point search kernel (counterpart of ``repro/kernels/support_match.py``).

:func:`support_match` replaces ``support_match_pallas``: on a CUDA tensor it
launches the hand-written kernel in ``csrc/support_match.cu`` (one launch for
all candidate rows of a frame, or of every frame of a wave, read through
their strides); on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.support_match_rows_streaming`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

# Number of kernel launches since the last reset (CPU calls do not count).
launches = 0


# ielas_support_match(desc_l, desc_r, out, frame_stride_l, row_stride_l,
#                     frame_stride_r, row_stride_r, batch, gh, w, gw, num_disp,
#                     step, offset, support_texture, ratio, lr_threshold,
#                     disp_min, stream)
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]

# The kernel's limits (csrc/support_match.cu), held on every device: d is the
# low 10 bits of its packed key, a row's columns fit shared memory in 8
# spans, and rows and frames are grid dimensions.
SUPPORT_MAX_DISP = 1024
SUPPORT_MAX_WIDTH = 32768
SUPPORT_MAX_ROWS = 65535


@functools.cache
def _kernel():
    return _build.bind("support_match", "ielas_support_match", ARGTYPES)


def _strides(t: torch.Tensor) -> tuple[int, int]:
    """(frame, row) strides of ([B,] GH, W, 16) rows, in 16-byte descriptors;
    each row's W x 16 bytes must be contiguous."""
    if t.stride(-1) != 1 or (t.shape[-2] > 1 and t.stride(-2) != 16):
        raise ValueError("each descriptor row must be contiguous")
    row = t.stride(-3) if t.shape[-3] > 1 else 0
    frame = t.stride(0) if t.dim() == 4 and t.shape[0] > 1 else 0
    if row % 16 or frame % 16 or t.data_ptr() % 16:
        raise ValueError("descriptor rows must start on 16-byte boundaries")
    return frame // 16, row // 16


def support_match(
    desc_l_rows: torch.Tensor,  # ([B,] GH, W, 16) int8 -- left descriptors, candidate rows
    desc_r_rows: torch.Tensor,  # ([B,] GH, W, 16) int8
    *,
    num_disp: int,
    step: int,
    offset: int,
    support_texture: int,
    support_ratio: float,
    lr_threshold: int,
    disp_min: int,
) -> torch.Tensor:
    """([B,] GH, W // step) float32 support disparities (INVALID = -1).

    A leading batch axis holds the frames of a wave: each frame's grid
    equals the one its rows alone give (the search is row by row).  The
    rows may be a strided view (the candidate rows of a descriptor map)
    whose rows are each contiguous.
    """
    if desc_l_rows.dim() not in (3, 4) or desc_l_rows.shape[-1] != 16:
        raise ValueError(
            f"descriptor rows must be ([B,] GH, W, 16), got {tuple(desc_l_rows.shape)}"
        )
    if desc_r_rows.shape != desc_l_rows.shape:
        raise ValueError(
            f"view shapes differ: {tuple(desc_l_rows.shape)} vs {tuple(desc_r_rows.shape)}"
        )
    if desc_l_rows.dtype != torch.int8 or desc_r_rows.dtype != torch.int8:
        raise TypeError("descriptor rows must be int8")
    if desc_r_rows.device != desc_l_rows.device:
        raise ValueError("both views must be on one device")
    if num_disp < 1 or step < 1 or not 0 <= offset < step:
        raise ValueError(f"bad search geometry: num_disp={num_disp} step={step} offset={offset}")
    *lead, gh, w, _ = desc_l_rows.shape
    batch = lead[0] if lead else 1
    if num_disp > SUPPORT_MAX_DISP:
        raise ValueError(f"num_disp <= {SUPPORT_MAX_DISP} (the kernel's key), got {num_disp}")
    if w > SUPPORT_MAX_WIDTH:
        raise ValueError(f"width <= {SUPPORT_MAX_WIDTH} (the kernel's shared memory), got {w}")
    if gh > SUPPORT_MAX_ROWS or batch > SUPPORT_MAX_ROWS:
        raise ValueError(f"at most {SUPPORT_MAX_ROWS} rows and frames, got {gh} and {batch}")
    kwargs = dict(
        num_disp=num_disp, step=step, offset=offset, support_texture=support_texture,
        support_ratio=support_ratio, lr_threshold=lr_threshold, disp_min=disp_min,
    )
    device = desc_l_rows.device
    gw = w // step
    if device.type == "cpu":
        out = ref.support_match_rows_streaming(
            desc_l_rows.reshape(batch * gh, w, 16), desc_r_rows.reshape(batch * gh, w, 16),
            **kwargs,
        )
        return out.reshape(*lead, gh, gw)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    strides = [*_strides(desc_l_rows), *_strides(desc_r_rows)]
    out = torch.empty((*lead, gh, gw), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(device):
        err = fn(
            desc_l_rows.data_ptr(), desc_r_rows.data_ptr(), out.data_ptr(), *strides,
            batch, gh, w, gw, num_disp, step, offset, support_texture,
            support_ratio, lr_threshold, disp_min,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"support_match kernel launch failed: cudaError_t {err}")
    global launches
    launches += 1
    return out
