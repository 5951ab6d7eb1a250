"""3x3 Sobel kernel (counterpart of ``repro/kernels/sobel.py``).

:func:`sobel` replaces ``sobel_pallas``: on a CUDA tensor it launches the
hand-written kernel in ``csrc/sobel.cu`` (one launch for a whole stack of
images, e.g. both views of a wave); on a CPU tensor it runs the plain
version, :func:`repro_torch.kernels.ref.sobel_rows_ref`, on the
edge-padded image.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

# Number of kernel launches since the last reset (CPU calls do not count).
launches = 0


# ielas_sobel(image, gx, gy, n, h, w, stream)
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@functools.cache
def _kernel():
    return _build.bind("sobel", "ielas_sobel", ARGTYPES)


def sobel(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W) image of grey levels -> (gx, gy), each (..., H, W) int8.

    The image is cast to int32 first (a float truncates toward zero, as the
    reference's ``astype(int32)`` does); borders replicate the edge pixel.
    """
    if image.dim() < 2 or image.shape[-2] < 1 or image.shape[-1] < 1:
        raise ValueError(f"image must be (..., H, W), got {tuple(image.shape)}")
    if image.dtype.is_complex or image.dtype == torch.bool:
        raise TypeError(f"image must hold real grey levels, got {image.dtype}")
    img = image.to(torch.int32)
    device = img.device
    if device.type == "cpu":
        return ref.sobel_rows_ref(*ref.edge_row_views(img))
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    img = img.contiguous()
    h, w = img.shape[-2:]
    n = img.numel() // (h * w)
    gx = torch.empty(img.shape, dtype=torch.int8, device=device)
    gy = torch.empty(img.shape, dtype=torch.int8, device=device)
    if n == 0:
        return gx, gy
    fn = _kernel()
    with torch.cuda.device(device):
        err = fn(img.data_ptr(), gx.data_ptr(), gy.data_ptr(), n, h, w,
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"sobel kernel launch failed: cudaError_t {err}")
    global launches
    launches += 1
    return gx, gy
