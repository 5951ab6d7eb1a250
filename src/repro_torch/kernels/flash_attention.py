"""Flash attention kernel, forward and backward (counterpart of
``repro/kernels/flash_attention.py``).

:func:`flash_attention` replaces ``flash_attention_pallas``: on CUDA
tensors it launches the hand-written kernel in ``csrc/flash_attention.cu``
(one launch per call: a block per query tile and batch-head, the key/value
tiles walked inside the block; bfloat16 on the tensor cores with ``wgmma``
fed by TMA, float32 on the CUDA cores); on CPU tensors it runs the plain
version, :func:`repro_torch.kernels.ref.flash_attention_ref`.  The layout is
the reference's: q (B, H, Sq, D), k and v (B, H, Skv, D), no grouped-query
heads.  The kernel's tiles are fixed, so there are no block-size arguments.
Beyond the Pallas kernel it takes gemma2's two options, a sliding window and
a score softcap (the reference computes them in plain JAX,
``repro/models/attention.py``), so that every attention of the LM path runs
on it.

Under a mesh: on DTensor inputs (the models under ``use_mesh`` and
``use_rules``) the call runs through ``local_map``, the kernel (or, on the
CPU, the plain version) on each rank's local shards, its backward too:
batch split over the rules' "batch" axes, heads over "heads".

Training: on CUDA tensors that require a gradient (under grad mode) the call
goes through :class:`_FlashFn`, whose forward launches the same kernel with
each row's log-sum-exp as a second output and whose backward launches the
hand-written ``csrc/flash_attention_bwd.cu`` (dQ, dK, dV: Delta, then dK/dV
and dQ in two deterministic passes; bfloat16 on the tensor cores with
``wgmma`` fed by TMA, float32 on the CUDA cores; the reference has no
backward kernel: XLA differentiates its plain-JAX attention).  No CUDA call
with such inputs reaches the kernel any other way, so the gradient never
stops at an output without a ``grad_fn``.  On CPU tensors autograd
differentiates the plain version, which is the backward's plain twin.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import _build, ref

# Number of kernel launches since the last reset (CPU calls do not count):
# the forward's, and the backward's (one a backward call: Delta, dK/dV, dQ).
launches = 0
backward_launches = 0

#: Head widths the kernel is compiled for.
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Query rows of a block in both kernels; the query tiles run on grid y.
_QUERY_TILE = 128

# ielas_flash_attention_lse(q, k, v, out, lse, bh, sq, skv, d, dtype, causal, window,
#                           scale, softcap, stream); lse may be null
ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
# ielas_flash_attention_bwd(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, sq, skv, d,
#                           dtype, causal, window, scale, softcap, stream)
BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


@functools.cache
def _kernel():
    return _build.bind("flash_attention", "ielas_flash_attention_lse", ARGTYPES)


@functools.cache
def _bwd_kernel():
    return _build.bind("flash_attention_bwd", "ielas_flash_attention_bwd", BWD_ARGTYPES)


def flash_attention(
    q: torch.Tensor,          # (B, H, Sq, D)
    k: torch.Tensor,          # (B, H, Skv, D)
    v: torch.Tensor,          # (B, H, Skv, D)
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """softmax(s) v with s = q k^T / sqrt(D), computed in float32, in q's
    dtype (float32 or bfloat16).  With ``softcap > 0`` each scaled score s
    becomes ``softcap * tanh(s / softcap)`` before the mask.  With ``causal``
    key position j is visible to query position i iff j <= i, both counted
    from 0; with ``window > 0`` (causal only) also iff i - j < window, so row
    i sees keys max(0, i - window + 1) .. i.  Masked scores are -1e30, as the
    reference's."""
    if isinstance(q, DTensor):
        return _on_mesh(q, k, v, causal, window, softcap)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, H, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k and v must be (B, H, Skv, D) with q's B, H and D, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)} for q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if window < 0 or (window > 0 and (not causal or q.shape[2] > k.shape[2])):
        raise ValueError(f"window must be 0, or > 0 with causal and Sq <= Skv (so that every "
                         f"row sees its own position); got {window} with causal={causal}, "
                         f"Sq {q.shape[2]}, Skv {k.shape[2]}")
    if not (softcap >= 0.0 and math.isfinite(softcap)):
        raise ValueError(f"softcap must be finite and >= 0, got {softcap}")
    device = q.device
    if k.device != device or v.device != device:
        raise ValueError("q, k and v must be on one device")
    if device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d} not supported by the kernel (one of {HEAD_DIMS})")
    if -(-sq // _QUERY_TILE) > 65535:
        raise ValueError(f"Sq = {sq} exceeds the kernel's grid (65535 query tiles of "
                         f"{_QUERY_TILE})")
    q, k, v = (t.contiguous() for t in (q, k, v))
    for t in (q, k, v):
        if t.data_ptr() % 16:    # TMA reads bases (and row strides) on 16 bytes
            raise ValueError("q, k and v must be 16-byte aligned")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashFn.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap, with_lse=False)[0]


def _on_mesh(q, k, v, causal: bool, window: int, softcap: float):
    """:func:`flash_attention` on each rank's local shards of DTensor q, k
    and v: out split as q, over "batch" and "heads" (the rules' placements
    of (B, H, S, D)).  The kernel attends each query row over every key of
    its head, so the sequence dimensions are gathered wherever the rules
    split them (``seq_kv`` in long decode), and k and v take q's split of
    the heads (a local slice where the KV heads replicate): explicit
    redistributes here, which are no-ops where the layouts already agree."""
    from repro_torch.distributed import sharding

    if not (isinstance(k, DTensor) and isinstance(v, DTensor)):
        raise TypeError("flash_attention: q is a DTensor, so k and v must be DTensors too")
    if not sharding.on_mesh():
        raise ValueError("flash_attention on DTensors needs a mesh and rules in scope "
                         "(distributed.sharding.use_mesh and use_rules)")
    mesh = q.device_mesh
    placements = sharding.logical_placements(("batch", "heads", None, None), mesh=mesh)
    q, k, v = (t.redistribute(mesh, placements) for t in (q, k, v))
    local = local_map(functools.partial(flash_attention, causal=causal, window=window,
                                        softcap=softcap),
                      out_placements=list(placements), in_placements=(placements,) * 3,
                      device_mesh=mesh)
    return local(q, k, v)


def _forward(q, k, v, causal: bool, window: int, softcap: float, with_lse: bool):
    """(out, lse or None): one forward launch on checked, contiguous CUDA
    tensors; ``lse`` (B * H, Sq) float32 in the log2 domain."""
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b * h, sq), dtype=torch.float32, device=q.device) if with_lse
           else None)
    if out.numel() == 0:
        return out, lse
    if k.shape[2] == 0:          # no key: every row sums to 0, as the plain version's
        return out.zero_(), lse
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 b * h, sq, k.shape[2], d, _DTYPES[q.dtype], int(causal),
                 min(int(window), 2**31 - 1),   # a wider window sees what 2^31 - 1 does
                 1.0 / math.sqrt(d), float(softcap),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    global launches
    launches += 1
    return out, lse


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                             softcap: float = 0.0):
    """(dq, dk, dv) of :func:`flash_attention` on CUDA tensors: ``out`` and
    ``lse`` from the forward launch with the log-sum-exp (:class:`_FlashFn`)
    on the same contiguous q, k, v and options, ``dout`` the output's
    gradient.  One call launches the three kernels of
    ``csrc/flash_attention_bwd.cu`` (Delta = rowsum(dout * out), then dK/dV
    and dQ; bfloat16 by ``wgmma`` on the tensor cores, float32 on the CUDA
    cores); the gradients are in q's dtype."""
    b, h, sq, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dout = dout.to(q.dtype).contiguous()
    if dout.data_ptr() % 16:     # TMA reads bases on 16 bytes, as q, k and v
        dout = dout.clone()
    # Scratch: each row's Delta and a copy of its log-sum-exp, rows of sq
    # rounded up to 4 floats (the bfloat16 kernels read them through a tensor
    # map, whose strides are multiples of 16 bytes).
    delta = torch.empty(2 * b * h * (-(-sq // 4) * 4), dtype=torch.float32, device=q.device)
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b * h, sq, k.shape[2], d, _DTYPES[q.dtype], int(causal),
                 min(int(window), 2**31 - 1), 1.0 / math.sqrt(d), float(softcap),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention backward launch failed: cudaError_t {err}")
    global backward_launches
    backward_launches += 1
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """The kernel under autograd: the forward keeps each row's log-sum-exp,
    the backward is :func:`flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _forward(q, k, v, causal, window, softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout, **ctx.options)
        return dq, dk, dv, None, None, None
