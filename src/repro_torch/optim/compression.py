"""Error-feedback int8 gradient compression (counterpart of
``repro/optim/compression.py``).

Two uses: an int8 (+ per-block scales) gradient-accumulation buffer, and
payloads of cross-host gradient reductions 4x smaller, with the
quantisation error fed back into the next step instead of lost (EF-SGD).

Block-wise symmetric quantisation: per block of BLOCK values, scale =
max|x| / 127.
"""
from __future__ import annotations

import math

import torch

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat, pad


def ef_compress(x: torch.Tensor, error: torch.Tensor | None = None):
    """Quantise x (+ carried error) to int8.  Returns (q, scales, new_error):
    new_error has x's shape; (q, scales) represent dequant(q) ~= x + error."""
    x32 = x.float()
    if error is not None:
        x32 = x32 + error.float()
    flat, pad = _pad_to_block(x32)
    blocks = flat.reshape(-1, BLOCK)
    scales = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    safe = torch.clamp(scales, min=1e-12)
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    deq = q.float() * safe
    err_flat = (blocks - deq).reshape(-1)
    if pad:
        err_flat = err_flat[:-pad]
    return q, scales, err_flat.reshape(x.shape)


def ef_decompress(q: torch.Tensor, scales: torch.Tensor, shape,
                  dtype=torch.float32) -> torch.Tensor:
    deq = (q.float() * scales).reshape(-1)
    return deq[:math.prod(shape)].reshape(shape).to(dtype)


def compression_ratio(shape) -> float:
    """Payload bytes int8+scales vs fp32."""
    n = math.prod(shape)
    blocks = (n + BLOCK - 1) // BLOCK
    return (n * 1 + blocks * 4) / (n * 4)
