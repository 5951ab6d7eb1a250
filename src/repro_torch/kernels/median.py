"""Valid-aware 3x3 median kernel (counterpart of ``repro/kernels/median.py``).

:func:`median3x3` replaces ``median3x3_pallas``: on a CUDA tensor it
launches the hand-written kernel in ``csrc/median.cu`` (one launch for a
whole stack of maps, e.g. every frame of a wave); on a CPU tensor it runs
the plain version, :func:`repro_torch.kernels.ref.median3x3_rows_ref`, on
the edge-padded map.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

# Number of kernel launches since the last reset (CPU calls do not count).
launches = 0

# A block of the kernel takes 8 rows of a map, and the grid's y axis holds at
# most 65535 blocks.  median3x3 raises beyond it on every device, so the CPU
# and the card take the same inputs.
MEDIAN_MAX_HEIGHT = 8 * 65535


# ielas_median3x3(disp, out, n, h, w, stream)
ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@functools.cache
def _kernel():
    return _build.bind("median", "ielas_median3x3", ARGTYPES)


def median3x3(disp: torch.Tensor) -> torch.Tensor:
    """(..., H, W) float32 disparities -> their 3x3 median over valid
    pixels: invalid (-1) neighbours take the centre's value, and invalid
    pixels stay invalid.  Borders replicate the edge pixel."""
    if disp.dim() < 2 or disp.shape[-2] < 1 or disp.shape[-1] < 1:
        raise ValueError(f"disparities must be (..., H, W), got {tuple(disp.shape)}")
    if disp.dtype != torch.float32:
        raise TypeError(f"disparities must be float32, got {disp.dtype}")
    if disp.shape[-2] > MEDIAN_MAX_HEIGHT:
        raise ValueError(f"the median kernel takes maps of at most {MEDIAN_MAX_HEIGHT} rows, "
                         f"got {disp.shape[-2]}")
    device = disp.device
    if device.type == "cpu":
        return ref.median3x3_rows_ref(*ref.edge_row_views(disp))
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    disp = disp.contiguous()
    h, w = disp.shape[-2:]
    n = disp.numel() // (h * w)
    out = torch.empty_like(disp)
    if n == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(device):
        err = fn(disp.data_ptr(), out.data_ptr(), n, h, w,
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"median3x3 kernel launch failed: cudaError_t {err}")
    global launches
    launches += 1
    return out
