"""Flash attention kernel, forward and backward (counterpart of
``repro/kernels/flash_attention.py``).

:func:`flash_attention` replaces ``flash_attention_pallas``.  It runs the
op ``repro_torch::flash_fwd``: on CUDA tensors one launch of the
hand-written kernel in ``csrc/flash_attention.cu`` (a block per query tile
and batch-head, the key/value tiles walked inside the block; bfloat16 on the
tensor cores with ``wgmma`` fed by TMA, float32 on the CUDA cores); on CPU
tensors the plain version, :func:`repro_torch.kernels.ref.flash_attention_ref`.
The layout is the reference's: q (B, H, Sq, D), k and v (B, H, Skv, D), no
grouped-query heads.  The kernel's tiles are fixed, so there are no
block-size arguments.  Beyond the Pallas kernel it takes gemma2's two
options, a sliding window and a score softcap (the reference computes them
in plain JAX, ``repro/models/attention.py``), so that every attention of the
LM path runs on it.

Training: the op's autograd formula is ``repro_torch::flash_bwd``, whose
CUDA path launches the hand-written ``csrc/flash_attention_bwd.cu`` (dQ, dK,
dV: Delta, then dK/dV and dQ in two deterministic passes; bfloat16 on the
tensor cores with ``wgmma`` fed by TMA, float32 on the CUDA cores; the
reference has no backward kernel: XLA differentiates its plain-JAX
attention) on the forward's output and each row's log-sum-exp, which the
forward writes where a gradient is wanted.  On CPU tensors it is the plain
version's gradient (``ref.flash_attention_bwd_ref``).

Both ops are ``torch.library`` custom ops with fake implementations and
flop formulas, so that ``FakeTensorMode`` traces them without a card (the
dry run, ``launch/dryrun.py``) and ``FlopCounterMode`` counts 4 B H D flops
per visible (query, key) pair forward, 2.5 times that backward.  The ops
take plain tensors: DTensors go through ``models/attention._attend``, which
runs them on each rank's local shards.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.utils.flop_counter import register_flop_formula

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
    reference's.  Runs the op ``repro_torch::flash_fwd`` (the log-sum-exp
    too where a gradient is wanted)."""
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
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda":
        if d not in HEAD_DIMS:
            raise ValueError(f"head width {d} not supported by the kernel (one of {HEAD_DIMS})")
        if -(-sq // _QUERY_TILE) > 65535:
            raise ValueError(f"Sq = {sq} exceeds the kernel's grid (65535 query tiles of "
                             f"{_QUERY_TILE})")
    with_lse = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                            or v.requires_grad)
    return flash_fwd(q, k, v, causal, int(window), float(softcap), with_lse)[0]


# --------------------------------------------------------------------------
# the ops: torch.library custom ops, so that autograd, FakeTensorMode (the
# dry run's tracing on fake tensors) and FlopCounterMode see the kernels
# --------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
              softcap: float, with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): one launch of ``csrc/flash_attention.cu`` on CUDA
    tensors, the plain version on CPU tensors.  ``lse`` is each row's
    log-sum-exp in the log2 domain, (B * H, Sq) float32, or an empty tensor
    without ``with_lse``."""
    if q.device.type == "cpu":
        return _plain_forward(q, k, v, causal, window, softcap, with_lse)
    q, k, v = (t.contiguous() for t in (q, k, v))
    for t in (q, k, v):
        if t.data_ptr() % 16:    # TMA reads bases (and row strides) on 16 bytes
            raise ValueError("q, k and v must be 16-byte aligned")
    out, lse = _forward(q, k, v, causal, window, softcap, with_lse)
    return out, lse if with_lse else out.new_empty((0,), dtype=torch.float32)


@flash_fwd.register_fake
def _(q, k, v, causal, window, softcap, with_lse):
    b, h, sq, _ = q.shape
    lse_shape = (b * h, sq) if with_lse else (0,)
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(lse_shape, dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=())
def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
              lse: torch.Tensor, dout: torch.Tensor, causal: bool, window: int,
              softcap: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the three launches of ``csrc/flash_attention_bwd.cu`` on
    CUDA tensors (:func:`flash_attention_backward`), the plain version's
    gradient on CPU tensors."""
    if q.device.type == "cpu":
        return _plain_backward(q, k, v, out, lse, dout, causal, window, softcap)
    q, k, v, out = (t.contiguous() for t in (q, k, v, out))
    return flash_attention_backward(q, k, v, out, lse, dout, causal=causal, window=window,
                                    softcap=softcap)


@flash_bwd.register_fake
def _(q, k, v, out, lse, dout, causal, window, softcap):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v))


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, softcap, _ = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.options = (causal, window, softcap)


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, out, lse, dout, *ctx.options)
    return dq, dk, dv, None, None, None, None


flash_fwd.register_autograd(_backward, setup_context=_setup_context)


def _plain_forward(q, k, v, causal, window, softcap, with_lse):
    out = ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    lse = (ref.flash_lse_ref(q, k, causal=causal, window=window, softcap=softcap) if with_lse
           else out.new_empty((0,), dtype=torch.float32))
    return out, lse


def _plain_backward(q, k, v, out, lse, dout, causal, window, softcap):
    return ref.flash_attention_bwd_ref(q, k, v, dout, causal=causal, window=window,
                                       softcap=softcap)


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the kernel computes: every pair without
    ``causal``; with it the key positions j <= i of each query row i (both
    from 0), and with ``window`` also i - j < window (the §6 bounds' count;
    the kernel never visits a fully masked tile)."""
    if not causal:
        return sq * skv
    span = min(window, skv) if window > 0 else skv     # the most keys a row sees
    full = min(sq, span)                               # rows 0 .. full - 1 see i + 1 keys
    return full * (full + 1) // 2 + (sq - full) * span


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_fwd_flops(q_shape, k_shape, v_shape, causal, window, softcap, with_lse, *args,
                     **kwargs) -> int:
    """4 B H D per visible pair: q k^T and p v, two flops a multiply-add."""
    b, h, sq, d = q_shape
    return 4 * b * h * d * visible_pairs(sq, k_shape[2], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, dout_shape, causal,
                     window, softcap, *args, **kwargs) -> int:
    """2.5 times the forward's (s recomputed, dv, dp, dq, dk: five products
    against the forward's two), as ``PERF.md`` reckons the backward's bound."""
    b, h, sq, d = q_shape
    return 10 * b * h * d * visible_pairs(sq, k_shape[2], causal, window)


def _forward(q, k, v, causal: bool, window: int, softcap: float, with_lse: bool):
    """(out, lse or None): one forward launch on checked, contiguous CUDA
    tensors (the op's CUDA path); ``lse`` (B * H, Sq) float32 in the log2
    domain."""
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
    ``lse`` from the forward launch with the log-sum-exp (``flash_fwd``)
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
