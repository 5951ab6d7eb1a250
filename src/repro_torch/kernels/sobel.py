"""3x3 Sobel kernel (counterpart of ``repro/kernels/sobel.py``).

:func:`sobel` replaces ``sobel_pallas``: on a CUDA tensor it launches the
hand-written kernel in ``csrc/sobel.cu`` (one launch for a whole stack of
images, e.g. both views of a wave); on a CPU tensor it runs the plain
version, :func:`repro_torch.kernels.ref.sobel_rows_ref`, on the
edge-padded image.  The kernel reads uint8, int32 and float32 grey levels
as they are (the cast to int32 happens inside it); any other type is cast
to int32 first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

# Number of kernel launches since the last reset (CPU calls do not count).
launches = 0


# ielas_sobel(image, gx, gy, n, h, w, kind, stream)
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

# The grey-level types the kernel reads itself (its `kind` argument).
KINDS = {torch.uint8: 0, torch.int32: 1, torch.float32: 2}


@functools.cache
def _kernel():
    return _build.bind("sobel", "ielas_sobel", ARGTYPES)


def sobel(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W) image of grey levels -> (gx, gy), each (..., H, W) int8.

    The grey levels are taken as int32 (a float truncates toward zero, as the
    reference's ``astype(int32)`` does); borders replicate the edge pixel.
    """
    if image.dim() < 2 or image.shape[-2] < 1 or image.shape[-1] < 1:
        raise ValueError(f"image must be (..., H, W), got {tuple(image.shape)}")
    if image.dtype.is_complex or image.dtype == torch.bool:
        raise TypeError(f"image must hold real grey levels, got {image.dtype}")
    device = image.device
    if device.type == "cpu":
        return ref.sobel_rows_ref(*ref.edge_row_views(image.to(torch.int32)))
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    img = image if image.dtype in KINDS else image.to(torch.int32)
    img = img.contiguous()
    h, w = img.shape[-2:]
    n = img.numel() // (h * w)
    gx = torch.empty(img.shape, dtype=torch.int8, device=device)
    gy = torch.empty(img.shape, dtype=torch.int8, device=device)
    if n == 0:
        return gx, gy
    fn = _kernel()
    with torch.cuda.device(device):
        err = fn(img.data_ptr(), gx.data_ptr(), gy.data_ptr(), n, h, w, KINDS[img.dtype],
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"sobel kernel launch failed: cudaError_t {err}")
    global launches
    launches += 1
    return gx, gy
