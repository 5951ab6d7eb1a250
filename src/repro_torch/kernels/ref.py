"""Plain PyTorch versions of the kernels, and the shared math
(counterpart of ``repro/kernels/ref.py``).

These functions define what the CUDA kernels compute: the CPU path runs
them, and the card's kernels are held against them bit for bit.  A scan
over the disparity axis is a Python loop here and a loop inside the kernel
on the card.

The cost row at disparity ``d`` is

    CV[d, u] = sum_k | desc_L[u, k] - desc_R[u - d, k] |        (int32)

and the right view's row is its diagonal, ``CV_R[d, u] = CV[d, u + d]``, so
one sweep of ``d`` serves both views.
"""
from __future__ import annotations

import math

import numpy as np
import torch

BIG = 1 << 28
BIGF = 1e9
INVALID = -1.0


def descriptor_texture(desc: torch.Tensor) -> torch.Tensor:
    """Sum of absolute descriptor entries -- the libelas texture measure."""
    return desc.to(torch.int32).abs().sum(dim=-1, dtype=torch.int32)


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _f64(v):
    """A float32 operand widened to float64: a tensor is converted on its
    device; a Python number is rounded to float32 and stays a number, so it
    costs no tensor and no launch."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).double()
    return float(np.float32(v))


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` for float32 operands, rounded once as a fused multiply-add.

    XLA:CPU contracts ``c + a * b`` into an FMA, and the port reproduces
    that rounding to stay bit-exact.  The product of two float32 values is
    exact in float64; the float64 sum's rounding error is recovered exactly
    (TwoSum) and folded into the last bit (round to odd), so the one
    rounding to float32 that follows is the FMA's correctly rounded result
    on every input -- the same bits as CUDA's ``__fmaf_rn``.  At least one
    operand is a tensor.  On the card each step is one small kernel (18
    for three tensor operands), so callers fold their FMAs into as few
    calls as they can.  Differentiable: the gradient is that of ``a * b +
    c``.
    """
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in (a, b, c)):
        return _Fma.apply(a, b, c)
    return _fma_values(a, b, c)


def _fma_values(a, b, c) -> torch.Tensor:
    a, b, c = _f64(a), _f64(b), _f64(c)
    prod = a * b
    s = prod + c
    t = s - prod
    err = (prod - (s - t)) + (c - t)
    # Round to odd: an inexact sum with an even last bit moves one ulp
    # toward the exact value (err * inf is +-inf; where err == 0 it is NaN,
    # and that lane keeps s).
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    return torch.where(fix, torch.nextafter(s, err * float("inf")), s).float()


class _Fma(torch.autograd.Function):
    """:func:`fma_f32` under autograd (its round to odd has no gradient)."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.numbers = tuple(None if isinstance(t, torch.Tensor) else t for t in (a, b))
        ctx.shapes = tuple(t.shape if isinstance(t, torch.Tensor) else None for t in (a, b, c))
        ctx.save_for_backward(*(t if isinstance(t, torch.Tensor) else None for t in (a, b)))
        return _fma_values(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = (t if t is not None else n for t, n in zip(ctx.saved_tensors, ctx.numbers))
        grads = [None, None, None]
        for i, other in ((0, b), (1, a)):
            if ctx.needs_input_grad[i]:
                grads[i] = (g * other).sum_to_size(ctx.shapes[i])
        if ctx.needs_input_grad[2]:
            grads[2] = g.sum_to_size(ctx.shapes[2])
        return tuple(grads)


# --------------------------------------------------------------------------
# XLA:CPU's float32 tanh
# --------------------------------------------------------------------------
# Eigen's generic_fast_tanh_float: a rational function of x clamped to
# [-7.99881172180175781, 7.99881172180175781] (x itself where |x| < 0.0004),
# each Horner step one FMA.  torch.tanh differs from it in over half of
# float32 outputs (a last bit).
_TANH_CLAMP = 7.99881172180175781
_TANH_TINY = 0.0004
_TANH_ALPHA = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
               5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
               4.89352455891786e-03)        # alpha_13, alpha_11, .., alpha_1
_TANH_BETA = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
              4.89352518554385e-03)         # beta_6, beta_4, beta_2, beta_0


def _xla_tanh_values(x: torch.Tensor) -> torch.Tensor:
    xc = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    p = fma_f32(x2, _TANH_ALPHA[0], _TANH_ALPHA[1])
    for coef in _TANH_ALPHA[2:]:
        p = fma_f32(x2, p, coef)
    p = xc * p
    q = fma_f32(x2, _TANH_BETA[0], _TANH_BETA[1])
    for coef in _TANH_BETA[2:]:
        q = fma_f32(x2, q, coef)
    return torch.where(x.abs() < _f32(_TANH_TINY), x, p / q)


class _XlaTanh(torch.autograd.Function):
    """:func:`xla_tanh_f32` with tanh's derivative ``1 - y^2`` (the FMA
    steps have none of their own)."""

    @staticmethod
    def forward(x):
        return _xla_tanh_values(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (1 - y * y)


def xla_tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's ``tanh`` of float32 ``x`` (what ``jax.jit(jnp.tanh)``
    gives), bit for bit, differentiable.  (In bfloat16 torch.tanh gives the
    reference's values.)"""
    return _XlaTanh.apply(x)


def tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """The port's float32 tanh: XLA:CPU's (:func:`xla_tanh_f32`) on CPU
    tensors, where the tests hold the port to the jitted reference's bits;
    ``torch.tanh`` on the card, where nothing is held to XLA:CPU's bits and
    the rational form's tens of launches a call would lengthen host-bound
    steps."""
    return xla_tanh_f32(x) if x.device.type == "cpu" else torch.tanh(x)


# --------------------------------------------------------------------------
# XLA:CPU's float32 sum of a 2-D array
# --------------------------------------------------------------------------
# jax.jit(jnp.sum) on a float32 (R, C) array compiles (JAX 0.9, x86-64 with
# AVX-512) to this plan, read from its HLO and the LLVM IR it emits:
#   * while a dimension exceeds 32, a reduce-window: each axis of more than
#     32 is cut into windows of 32 (an axis of 32 or fewer is one window),
#     zero-padded to a multiple of 32 with the lower half of the padding
#     before; each window is summed from 0 in row-major order, one add
#     after another (KITTI's 375 x 1242 takes two rounds: 12 x 39 block
#     sums, then 1 x 2);
#   * the last (R, C) <= (32, 32) array is summed by one loop, which LLVM
#     vectorises across rows for some shapes (_xla_lanes): lane k sums rows
#     k, k + V, ... row-major, the lanes are added by halving (lane i + lane
#     i + V/2, ...), and the rows left over are added one element after
#     another.  Otherwise it is summed row-major from 0 in one chain.
# Summing in any other order changes the last bits (torch's .sum() is
# pairwise).  tests/test_torch_metrics.py holds this against jax.jit(jnp.sum).
_XLA_WINDOW = 32


def _xla_lanes(r: int, c: int) -> int:
    """The vector width LLVM gives the final (r, c) loop (1: not vectorised)."""
    if not 2 <= c <= 8:
        return 1
    if r in (2, 4, 8):
        return r
    if 20 <= r <= 23:
        return 4
    if 28 <= r <= 31:
        return 8 if c == 2 else 4
    if 16 <= r <= 32:
        return 8 if c <= 6 else 4
    return 1


def _chain_sums(rows: np.ndarray) -> np.ndarray:
    """Each row of a float32 (n, k) array summed from 0, one add after another."""
    start = np.zeros((rows.shape[0], 1), np.float32)
    return np.add.accumulate(np.concatenate([start, rows], axis=1), axis=1,
                             dtype=np.float32)[:, -1]


def xla_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """The sum of a 2-D float32 tensor, bit for bit as ``jax.jit(jnp.sum)``
    computes it on XLA:CPU: a float32 scalar on ``x``'s device.  Summed on
    the host."""
    if x.dim() != 2:
        raise ValueError(f"xla_sum_f32 takes a 2-D tensor, got {tuple(x.shape)}")
    a = x.detach().to("cpu", torch.float32).numpy()
    if a.size == 0:
        total = np.float32(0.0)
    elif a.shape == (1, 1):
        total = a[0, 0]                           # XLA copies the one element
    else:
        while a.shape[0] > _XLA_WINDOW or a.shape[1] > _XLA_WINDOW:
            (r, c), win = a.shape, (min(a.shape[0], _XLA_WINDOW), min(a.shape[1], _XLA_WINDOW))
            nr, nc = -(-r // win[0]), -(-c // win[1])
            pad = np.zeros((nr * win[0], nc * win[1]), np.float32)
            lo_r, lo_c = (nr * win[0] - r) // 2, (nc * win[1] - c) // 2
            pad[lo_r : lo_r + r, lo_c : lo_c + c] = a
            blocks = pad.reshape(nr, win[0], nc, win[1]).transpose(0, 2, 1, 3)
            a = _chain_sums(blocks.reshape(nr * nc, -1)).reshape(nr, nc)
        r, c = a.shape
        v = _xla_lanes(r, c)
        full = r // v * v
        lanes = _chain_sums(np.stack([a[k:full:v].reshape(-1) for k in range(v)]))
        while lanes.size > 1:
            lanes = (lanes[: lanes.size // 2] + lanes[lanes.size // 2 :]).astype(np.float32)
        # The rows left over, one add after another onto the lanes' sum.
        total = _chain_sums(np.concatenate([lanes, a[full:].reshape(-1)])[None, :])[0]
    return torch.tensor(total, dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------
# XLA:CPU's float32 exp and log
# --------------------------------------------------------------------------
# XLA:CPU evaluates float32 exp/log with the Cephes polynomials as Eigen
# writes them.  Every step below is one float32 operation (an FMA where
# Eigen uses one), in Eigen's order: a different order, or separate
# multiply and add, changes the last bit of up to a few percent of the
# results, and a near-tie between two dense candidates then resolves
# differently from the reference.  csrc/xla_math.cuh is the same sequence
# for the card (``__fmaf_rn``, built with ``--fmad=false``).
_EXP_HI = 88.3762626647950
_EXP_LO = -88.3762626647949
_EXP_POLY = (1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1,
             5.0000001201e-1)
_LN2_HI = 0.693359375
_LN2_LO = -2.12194440e-4
_TINY = 1.17549435e-38              # the smallest normal float32


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """2**n as float32, built from its bits (n in [-126, 127])."""
    return ((n + 127) << 23).to(torch.int32).view(torch.float32)


def xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``exp``, bit for bit (Cephes ``expf`` as Eigen's
    ``pexp_float`` computes it)."""
    x = x.clamp(_EXP_LO, _EXP_HI)
    fx = torch.floor(fma_f32(x, 1.44269504088896341, 0.5))
    r = fma_f32(fx, -_LN2_HI, x)
    r = fma_f32(fx, -_LN2_LO, r)
    z = r * r
    y = torch.full_like(x, 1.9875691500e-4)
    for coef in _EXP_POLY:
        y = fma_f32(y, r, coef)
    y = fma_f32(y, z, r) + 1
    # ldexp(y, fx) in two exact steps; XLA:CPU flushes a subnormal result
    # to zero (for x below about -87.34).
    n = fx.to(torch.int32)
    half = n >> 1
    out = y * _pow2(half) * _pow2(n - half)
    return torch.where(out < _f32(_TINY), 0.0, out)


def xla_softmax_f32(x: torch.Tensor, scale: float = 1.0,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """``jax.nn.softmax(where(mask, x * scale, -1e30))`` over the last axis
    of float32 ``x`` as XLA:CPU evaluates it: the max of the rounded
    products; ``exp`` (XLA's) of ``x * scale - max``, which XLA contracts
    into one FMA; divided by the sum (``torch.softmax`` uses another exp and
    multiplies by the sum's reciprocal).  The sum runs in torch's order, not
    XLA's, whose plan depends on the row's length (ROADMAP.md, queue 3).
    Differentiable: the gradient is the softmax's, ``p (g - sum(g p))``
    times ``scale`` (0 where masked)."""
    return _XlaSoftmax.apply(x, scale, mask)


class _XlaSoftmax(torch.autograd.Function):
    """:func:`xla_softmax_f32` with the softmax's own gradient (XLA's exp
    has none: it is built from bits)."""

    @staticmethod
    def forward(x, scale, mask):
        return _xla_softmax_values(x, scale, mask)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.scale = inputs[1]
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        gs = p * (g - (g * p).sum(-1, keepdim=True))
        return gs * ctx.scale, None, None


def _xla_softmax_values(x: torch.Tensor, scale: float, mask) -> torch.Tensor:
    s = x * scale
    if mask is not None:
        s = torch.where(mask, s, -1e30)
    shifted = fma_f32(x, scale, -s.amax(-1, keepdim=True))
    if mask is not None:
        shifted = torch.where(mask, shifted, -1e30)
    e = xla_exp_f32(shifted)
    return e / e.sum(-1, keepdim=True)


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log``, bit for bit, for positive normal ``x``
    (Cephes ``logf`` as Eigen's ``plog_float`` computes it)."""
    m, e = torch.frexp(x)                       # x = m * 2**e, m in [0.5, 1)
    e = e.to(torch.float32)
    low = m < _f32(0.707106781186547524)
    e = torch.where(low, e - 1, e)
    x = torch.where(low, (m - 1) + m, m - 1)
    x2 = x * x
    x3 = x2 * x
    y = fma_f32(fma_f32(x, 7.0376836292e-2, -1.1514610310e-1), x, 1.1676998740e-1)
    y1 = fma_f32(fma_f32(x, -1.2420140846e-1, 1.4249322787e-1), x, -1.6668057665e-1)
    y2 = fma_f32(fma_f32(x, 2.0000714765e-1, -2.4999993993e-1), x, 3.3333331174e-1)
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, e * _f32(_LN2_LO))
    x = fma_f32(x2, -0.5, x) + y
    return fma_f32(e, _LN2_HI, x)


def dense_energy(
    sad: torch.Tensor, d, mu: torch.Tensor, *, beta: float, gamma: float,
    two_s2: torch.Tensor,
) -> torch.Tensor:
    """The dense energy ``beta * SAD - log(gamma + exp(-(d - mu)^2 / 2 sigma^2))``
    in float32, rounded as XLA:CPU rounds it: XLA's exp and log, and the
    final ``beta * SAD + prior`` fused into one FMA.  ``two_s2`` is
    ``2 sigma^2`` as a tensor on ``mu``'s device (a true division there)."""
    diff = d - mu
    prior = -xla_log_f32(gamma + xla_exp_f32(-(diff * diff) / two_s2))
    return fma_f32(beta, sad.float(), prior)


def _sad_rows(desc_l: torch.Tensor, desc_r: torch.Tensor):
    """SAD-row helpers for the disparity sweeps.

    ``sad_row(d)`` is the (bh, W) int32 SAD row ``|dl[u] - dr[u - d]|``
    (zero where ``u < d``; callers mask it), and ``shift_left(row, d, fill)``
    its right-view diagonal ``row[u + d]`` (``fill`` past the right edge).
    """
    w = desc_l.shape[1]
    dl = desc_l.to(torch.int32)
    dr = desc_r.to(torch.int32)

    def sad_row(d: int) -> torch.Tensor:
        out = torch.zeros(dl.shape[:2], dtype=torch.int32, device=dl.device)
        if d < w:
            out[:, d:] = (dl[:, d:] - dr[:, : w - d]).abs().sum(dim=-1, dtype=torch.int32)
        return out

    def shift_left(row: torch.Tensor, d: int, fill: int) -> torch.Tensor:
        out = torch.full_like(row, fill)
        if d < w:
            out[:, : w - d] = row[:, d:]
        return out

    return sad_row, shift_left


# --------------------------------------------------------------------------
# streaming disparity scan: running-best registers over d
# --------------------------------------------------------------------------
# Four registers reproduce (argmin, min, second-min outside +-1 of argmin)
# exactly: the +-1 exclusion zone holds at most 3 entries, so the smallest
# kept cost outside the zone is the true excluded second minimum.  Strict-<
# insertion keeps ties at the smallest d, matching argmin.

def _insert4(vals: list, idxs: list, v: torch.Tensor, d: int) -> tuple[list, list]:
    """Insert cost ``v`` at disparity ``d`` into sorted 4-deep registers."""
    v1, v2, v3, v4 = vals
    i1, i2, i3, i4 = idxs
    dt = torch.full_like(i1, d)
    b1, b2, b3, b4 = v < v1, v < v2, v < v3, v < v4
    n_v1 = torch.where(b1, v, v1)
    n_i1 = torch.where(b1, dt, i1)
    n_v2 = torch.where(b1, v1, torch.where(b2, v, v2))
    n_i2 = torch.where(b1, i1, torch.where(b2, dt, i2))
    n_v3 = torch.where(b2, v2, torch.where(b3, v, v3))
    n_i3 = torch.where(b2, i2, torch.where(b3, dt, i3))
    n_v4 = torch.where(b3, v3, torch.where(b4, v, v4))
    n_i4 = torch.where(b3, i3, torch.where(b4, dt, i4))
    return [n_v1, n_v2, n_v3, n_v4], [n_i1, n_i2, n_i3, n_i4]


def _init4(shape: tuple, device) -> tuple[list, list]:
    """BIG-valued, index-0 registers: matches argmin==0 on all-BIG columns."""
    vals = [torch.full(shape, BIG, dtype=torch.int32, device=device) for _ in range(4)]
    idxs = [torch.zeros(shape, dtype=torch.int32, device=device) for _ in range(4)]
    return vals, idxs


def _finalize4(vals: list, idxs: list) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best, min1, min2) from 4-deep registers; min2 excludes |d - best| <= 1."""
    best, min1 = idxs[0], vals[0]
    min2 = torch.full_like(min1, BIG)
    for k in (1, 2, 3):
        min2 = torch.minimum(min2, torch.where((idxs[k] - best).abs() > 1, vals[k], BIG))
    return best, min1, min2


# --------------------------------------------------------------------------
# the support kernel's registers: packed keys, two per class of d mod 4
# --------------------------------------------------------------------------
# csrc/support_match.cu keeps a column's registers as keys cost << 10 | d
# (cost <= 16 * 255 < 2^12, d < 2^10), which order as (cost, d), and keeps
# the two least keys of each class of d mod 4 instead of the four least.
# Both are order-free: lists of disjoint d ranges merge exactly, whatever
# order the keys come in.  The least key gives _finalize4's best and min1;
# its min2 (the least cost of a d outside |d - best| <= 1) is, in each
# class, the least key or, when that one's d lies inside (at most one d of
# a class can), the second.  These helpers are the kernel's insert, merge
# and finalisation in plain PyTorch; tests/test_torch_support_facts.py holds
# them against _insert4 and _finalize4.
KEY_FILL = 0x7FFFFFFF


def support_key(cost: torch.Tensor, d: int) -> torch.Tensor:
    """Packed (cost, d) keys; a cost of BIG (out of the image) gives KEY_FILL."""
    return torch.where(cost >= BIG, KEY_FILL, (cost << 10) + d).to(torch.int32)


def keys_fill(shape: tuple, device=None) -> torch.Tensor:
    """Empty registers: (*shape, 4 classes, 2) keys."""
    return torch.full((*shape, 4, 2), KEY_FILL, dtype=torch.int32, device=device)


def keys_insert(keys: torch.Tensor, key: torch.Tensor, d: int) -> torch.Tensor:
    """One more key at disparity ``d`` into its class's two least (3 ops)."""
    out = keys.clone()
    lo, hi = keys[..., d % 4, 0], keys[..., d % 4, 1]
    out[..., d % 4, 0] = torch.minimum(lo, key)
    out[..., d % 4, 1] = torch.minimum(hi, torch.maximum(lo, key))
    return out


def keys_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The two least of each class of two lists."""
    lo = torch.minimum(a[..., 0], b[..., 0])
    hi = torch.minimum(torch.maximum(a[..., 0], b[..., 0]), torch.minimum(a[..., 1], b[..., 1]))
    return torch.stack([lo, hi], dim=-1)


def keys_finalize(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best, min1, min2) from the classes, as _finalize4 gives them."""
    fill = keys == KEY_FILL
    cost = torch.where(fill, BIG, keys >> 10)
    d = torch.where(fill, 0, keys & 1023)
    least = keys[..., 0].amin(dim=-1)
    best = torch.where(least == KEY_FILL, 0, least & 1023)
    min1 = torch.where(least == KEY_FILL, BIG, least >> 10)
    inside = (d[..., 0] - best[..., None]).abs() <= 1
    min2 = torch.where(inside, cost[..., 1], cost[..., 0]).amin(dim=-1)
    return best, min1, min2


# --------------------------------------------------------------------------
# support search
# --------------------------------------------------------------------------
def _support_decision(
    best_l: torch.Tensor,       # (bh, GW) int32 -- left argmin at candidates
    min1_l: torch.Tensor,
    min2_l: torch.Tensor,
    best_r: torch.Tensor,       # (bh, W) int32 -- right argmin everywhere
    min1_r: torch.Tensor,
    min2_r: torch.Tensor,
    desc_l: torch.Tensor,       # (bh, W, 16) int8
    desc_r: torch.Tensor,
    *,
    step: int,
    offset: int,
    support_texture: int,
    support_ratio: float,
    lr_threshold: int,
    disp_min: int,
) -> torch.Tensor:
    """Texture / uniqueness / L-R tests shared by both support formulations.

    The ratio test is float32 (``float(min1) < float32(ratio) * float(min2)``)
    as in the reference; the cross check reads the right view's result at
    ``clip(u - best_l, 0, W - 1)``.
    """
    w = desc_l.shape[1]
    gw = best_l.shape[-1]
    us = torch.arange(gw, device=desc_l.device) * step + offset
    tex_l = descriptor_texture(desc_l)[:, offset : offset + (gw - 1) * step + 1 : step]
    ok_l = (
        (min1_l.float() < support_ratio * min2_l.float())
        & (tex_l >= support_texture)
        & (min1_l < BIG)
    )
    ok_r = (
        (min1_r.float() < support_ratio * min2_r.float())
        & (descriptor_texture(desc_r) >= support_texture)
        & (min1_r < BIG)
    )
    ur = (us[None, :] - best_l).clamp(0, w - 1).long()
    d_r_at = torch.gather(best_r, 1, ur)
    ok_r_at = torch.gather(ok_r, 1, ur)
    consistent = (best_l - d_r_at).abs() <= lr_threshold
    margin_ok = us >= disp_min + 2
    valid = ok_l & ok_r_at & consistent & margin_ok[None, :]
    return torch.where(valid, best_l.float(), INVALID)


def _cost_row(sad_row, d: int) -> torch.Tensor:
    """Support cost row at ``d``: the SAD row with BIG where ``u - d < 0``."""
    row = sad_row(d)
    row[:, :d] = BIG
    return row


def support_match_rows_ref(
    desc_l: torch.Tensor,       # (bh, W, 16) int8 -- candidate rows of left image
    desc_r: torch.Tensor,       # (bh, W, 16) int8
    *,
    num_disp: int,
    step: int,
    offset: int,
    support_texture: int,
    support_ratio: float,
    lr_threshold: int,
    disp_min: int,
) -> torch.Tensor:
    """MATERIALISED support oracle: stacks the (bh, D, W) volumes and reduces
    them with argmin / min.  Ground truth for the streaming scan in tests;
    not used on the frame path."""
    w = desc_l.shape[1]
    gw = w // step
    sad_row, shift_left = _sad_rows(desc_l, desc_r)
    rows = [_cost_row(sad_row, d) for d in range(num_disp)]
    cv = torch.stack(rows, dim=1)                                    # (bh, D, W)
    cv_r = torch.stack([shift_left(r, d, BIG) for d, r in enumerate(rows)], dim=1)

    def best_two(cost):
        best = torch.argmin(cost, dim=1).to(torch.int32)
        min1 = cost.amin(dim=1)
        d_idx = torch.arange(cost.shape[1], device=cost.device)[None, :, None]
        near = (d_idx - best[:, None, :]).abs() <= 1
        min2 = torch.where(near, BIG, cost).amin(dim=1)
        return best, min1, min2

    best_l, min1_l, min2_l = best_two(cv[:, :, offset : offset + (gw - 1) * step + 1 : step])
    best_r, min1_r, min2_r = best_two(cv_r)
    return _support_decision(
        best_l, min1_l, min2_l, best_r, min1_r, min2_r, desc_l, desc_r,
        step=step, offset=offset, support_texture=support_texture,
        support_ratio=support_ratio, lr_threshold=lr_threshold, disp_min=disp_min,
    )


def support_match_rows_streaming(
    desc_l: torch.Tensor,       # (bh, W, 16) int8 -- candidate rows of left image
    desc_r: torch.Tensor,       # (bh, W, 16) int8
    *,
    num_disp: int,
    step: int,
    offset: int,
    support_texture: int,
    support_ratio: float,
    lr_threshold: int,
    disp_min: int,
) -> torch.Tensor:
    """Streaming support search: one loop over ``d`` in ``[0, num_disp)``.

    Returns (bh, W // step) float32: disparity or INVALID.  Each step folds
    one cost row into 4-deep (value, d) registers for the left view at the
    candidate columns ``offset + j * step`` and, through the diagonal
    ``CV_R[d, u] = CV[d, u + d]``, for the right view at every column.  As
    in the reference, the sweep starts at 0 whatever ``disp_min`` is;
    ``disp_min`` only enters the margin test ``u >= disp_min + 2``.
    """
    bh, w, _ = desc_l.shape
    gw = w // step
    sad_row, shift_left = _sad_rows(desc_l, desc_r)
    left = _init4((bh, gw), desc_l.device)
    right = _init4((bh, w), desc_l.device)
    for d in range(num_disp):
        cost = _cost_row(sad_row, d)
        cand = cost[:, offset : offset + (gw - 1) * step + 1 : step]
        left = _insert4(*left, cand, d)
        right = _insert4(*right, shift_left(cost, d, BIG), d)
    best_l, min1_l, min2_l = _finalize4(*left)
    best_r, min1_r, min2_r = _finalize4(*right)
    return _support_decision(
        best_l, min1_l, min2_l, best_r, min1_r, min2_r, desc_l, desc_r,
        step=step, offset=offset, support_texture=support_texture,
        support_ratio=support_ratio, lr_threshold=lr_threshold, disp_min=disp_min,
    )


# --------------------------------------------------------------------------
# streaming dense matching: scan-over-d candidate folding (gather-free)
# --------------------------------------------------------------------------
def upsample_cells(cells: torch.Tensor, w: int, cell_px: int) -> torch.Tensor:
    """(bh, CW) per-grid-cell values -> (bh, W) per-pixel columns.

    Pixel column ``u`` reads cell ``min(u // cell_px, CW - 1)``: each cell
    covers ``cell_px`` columns and the tail extends the last cell.
    """
    cols = (torch.arange(w, device=cells.device) // cell_px).clamp_(max=cells.shape[1] - 1)
    return cells[:, cols]


def dense_match_rows_stream_ref(
    desc_l: torch.Tensor,       # (bh, W, 16) int8
    desc_r: torch.Tensor,       # (bh, W, 16) int8
    mu_l: torch.Tensor,         # (bh, W) float32 plane prior
    mu_r: torch.Tensor,         # (bh, W) float32
    gmask_l: torch.Tensor,      # (bh, CW, D) bool grid-vector bitmask rows
    gmask_r: torch.Tensor,      # (bh, CW, D) bool
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
    """Streaming dense matching for both views: one loop over
    ``d`` in ``[disp_min, disp_min + num_disp)``.

    At each ``d`` a pixel's candidate mask is its cell's bitmask bit OR the
    band ``clip(round(mu) - R) <= d <= clip(round(mu) + R)``; where the mask
    holds and the matching column is inside the image, the energy

        beta * SAD - log(gamma + exp(-(d - mu)^2 / (2 sigma^2)))

    (float32, rounded as XLA:CPU rounds it: :func:`dense_energy`) is folded
    into running (best energy, best d) registers with a strict ``<``.  The
    energy is computed only where the mask holds (elsewhere it is BIGF,
    which never wins).  Returns (disp_l, disp_r), each (bh, W) float32 with
    INVALID where no candidate was valid or the texture is below
    ``match_texture``.
    """
    bh, w, _ = desc_l.shape
    dev = desc_l.device
    sad_row, shift_left = _sad_rows(desc_l, desc_r)
    u = torch.arange(w, device=dev)[None, :]
    lo_d = float(disp_min)
    hi_d = float(disp_min + num_disp - 1)
    # A device tensor, so the division is a true division on every device
    # (a Python scalar divisor becomes a reciprocal multiply on CUDA).
    two_s2 = torch.tensor(2.0 * sigma * sigma, dtype=torch.float32, device=dev)

    def prior_band(mu):
        r = torch.round(mu)
        return (r - plane_radius).clamp(lo_d, hi_d), (r + plane_radius).clamp(lo_d, hi_d)

    band_l = prior_band(mu_l)
    band_r = prior_band(mu_r)

    def update(state, sad, valid, mu, band, gcells, d):
        best_e, best_d = state
        df = float(d)
        mask = upsample_cells(gcells, w, cell_px) | ((band[0] <= df) & (band[1] >= df))
        mask &= valid
        e = torch.full_like(best_e, BIGF)
        e[mask] = dense_energy(sad[mask], df, mu[mask], beta=beta, gamma=gamma, two_s2=two_s2)
        better = e < best_e
        return torch.where(better, e, best_e), torch.where(better, d, best_d)

    def init():
        return (torch.full((bh, w), BIGF, dtype=torch.float32, device=dev),
                torch.zeros((bh, w), dtype=torch.int32, device=dev))

    left, right = init(), init()
    for i in range(num_disp):
        d = disp_min + i
        sad = sad_row(d)
        left = update(left, sad, u >= d, mu_l, band_l, gmask_l[:, :, i], d)
        right = update(right, shift_left(sad, d, 0), u + d < w, mu_r, band_r,
                       gmask_r[:, :, i], d)

    def finish(state, desc):
        emin, best = state
        valid = (emin < BIGF) & (descriptor_texture(desc) >= match_texture)
        return torch.where(valid, best.float(), INVALID)

    return finish(left, desc_l), finish(right, desc_r)


# --------------------------------------------------------------------------
# candidate-window dense matching
# --------------------------------------------------------------------------
def dense_match_rows_windowed_ref(
    desc_l: torch.Tensor,       # (bh, W, 16) int8
    desc_r: torch.Tensor,       # (bh, W, 16) int8
    mu_l: torch.Tensor,         # (bh, W) float32
    mu_r: torch.Tensor,         # (bh, W) float32
    cand_l: torch.Tensor,       # (bh, W, C) int32 candidate disparities
    cand_r: torch.Tensor,       # (bh, W, C) int32
    *,
    num_disp: int,
    disp_min: int,
    beta: float,
    gamma: float,
    sigma: float,
    match_texture: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate-window dense matching for both views: the energy at each of
    a pixel's C candidate disparities, minimised.

    One formulation for the reference's three ``gather_impl`` names (take,
    onehot, slice), which are bitwise equal by construction: a loop over the
    C candidate slots, each gathering the matching descriptors at
    ``u - d`` (left view) or ``u + d`` (right view).  A slot whose matching
    column is off the image has energy BIGF.  The result is the reference's
    ``min(where(e == emin, value, S))`` over the slots, ``S = disp_min +
    num_disp`` (past the end of the value domain): the smallest value at the
    minimum energy, capped at S when some slot lies above the minimum (a
    cap only values at or above S, outside the domain ``candidate_set``
    clips to, can meet).  A NaN energy makes ``emin`` NaN, as ``jnp.min``
    does.  ``valid = (emin < BIGF) & (texture >= match_texture)``.  Returns
    (disp_l, disp_r), each (bh, W) float32.
    """
    bh, w, _ = desc_l.shape
    dev = desc_l.device
    dl = desc_l.to(torch.int32)
    dr = desc_r.to(torch.int32)
    u = torch.arange(w, device=dev)[None, :]
    rows = torch.arange(bh, device=dev)[:, None]
    two_s2 = torch.tensor(2.0 * sigma * sigma, dtype=torch.float32, device=dev)

    sentinel = disp_min + num_disp

    def one_view(src, dst, mu, cands, sign):
        # Running (least energy, smallest value at it, some slot above it).
        emin = torch.full((bh, w), float("inf"), dtype=torch.float32, device=dev)
        best = torch.full((bh, w), sentinel, dtype=torch.int32, device=dev)
        above = torch.zeros((bh, w), dtype=torch.bool, device=dev)
        for c in range(cands.shape[-1]):
            d = cands[..., c]
            uc = u + sign * d
            inside = (uc >= 0) & (uc < w)
            sad = (src - dst[rows, uc.clamp(0, w - 1)]).abs().sum(dim=-1, dtype=torch.int32)
            e = torch.full_like(emin, BIGF)
            e[inside] = dense_energy(sad[inside], d[inside].float(), mu[inside], beta=beta,
                                     gamma=gamma, two_s2=two_s2)
            lower = e < emin
            above |= (lower & (emin < float("inf"))) | (e > emin)
            best = torch.where(lower, d, torch.where(e == emin, torch.minimum(best, d), best))
            emin = torch.minimum(e, emin)
        best = torch.where(above, best.clamp(max=sentinel), best)
        valid = (emin < BIGF) & (descriptor_texture(src) >= match_texture)
        return torch.where(valid, best.float(), INVALID)

    return one_view(dl, dr, mu_l, cand_l, -1), one_view(dr, dl, mu_r, cand_r, +1)


# --------------------------------------------------------------------------
# warm-start dense matching: the band-only scan around a previous disparity
# --------------------------------------------------------------------------
def warm_energy(sad: torch.Tensor, d, mu: torch.Tensor, *, beta: float,
                inv_2s2: float) -> torch.Tensor:
    """The warm energy ``beta * SAD - 1 / (1 + (d - mu)^2 * inv_2s2)`` in
    float32, rounded as XLA:CPU rounds it: the square rounded, ``1 + square
    * inv_2s2`` and ``beta * SAD + prior`` each one FMA, the division a true
    one.  ``d`` is a Python number (an integer, exact in float32) or a
    tensor; ``inv_2s2`` is rounded to float32 once, as the reference's
    Python float is where it meets float32."""
    diff = d - mu
    q = fma_f32(diff * diff, inv_2s2, 1.0)
    # A tensor numerator: ``-1.0 / q`` would be a reciprocal and a multiply.
    prior = torch.tensor(-1.0, dtype=torch.float32, device=q.device) / q
    return fma_f32(beta, sad.float(), prior)


def dense_match_rows_warm_ref(
    desc_l: torch.Tensor,       # (bh, W, 16) int8
    desc_r: torch.Tensor,       # (bh, W, 16) int8
    mu_l: torch.Tensor,         # (bh, W) float32 warm prior (the previous frame's seed)
    mu_r: torch.Tensor,         # (bh, W) float32
    *,
    num_disp: int,
    disp_min: int,
    warm_band: int,
    beta: float,
    sigma: float,
    match_texture: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Warm-start dense matching for both views: one loop over ``d`` in
    ``[disp_min, disp_min + num_disp)``, as the reference's scan.

    A pixel's candidates are only the band ``clip(round(mu) -/+ warm_band,
    disp_min, disp_min + num_disp - 1)`` -- no grid-vector bitmask -- cut to
    the image (left view ``u >= d``, right view ``u + d < W``).  There the
    energy :func:`warm_energy` is folded into running (best energy, best d)
    registers with a strict ``<`` from (BIGF, 0); elsewhere the energy is
    BIGF, which never wins.  Returns (disp_l, disp_r), each (bh, W) float32
    with INVALID where no candidate was valid or the texture is below
    ``match_texture``.
    """
    bh, w, _ = desc_l.shape
    dev = desc_l.device
    sad_row, shift_left = _sad_rows(desc_l, desc_r)
    u = torch.arange(w, device=dev)[None, :]
    lo_d = float(disp_min)
    hi_d = float(disp_min + num_disp - 1)
    inv_2s2 = 1.0 / (2.0 * sigma * sigma)

    def band(mu):
        r = torch.round(mu)
        return (r - warm_band).clamp(lo_d, hi_d), (r + warm_band).clamp(lo_d, hi_d)

    band_l = band(mu_l)
    band_r = band(mu_r)

    def update(state, sad, valid, mu, bnd, d):
        best_e, best_d = state
        df = float(d)
        mask = (bnd[0] <= df) & (bnd[1] >= df) & valid
        e = torch.full_like(best_e, BIGF)
        e[mask] = warm_energy(sad[mask], df, mu[mask], beta=beta, inv_2s2=inv_2s2)
        better = e < best_e
        return torch.where(better, e, best_e), torch.where(better, d, best_d)

    def init():
        return (torch.full((bh, w), BIGF, dtype=torch.float32, device=dev),
                torch.zeros((bh, w), dtype=torch.int32, device=dev))

    left, right = init(), init()
    for i in range(num_disp):
        d = disp_min + i
        sad = sad_row(d)
        left = update(left, sad, u >= d, mu_l, band_l, d)
        right = update(right, shift_left(sad, d, 0), u + d < w, mu_r, band_r, d)

    def finish(state, desc):
        emin, best = state
        valid = (emin < BIGF) & (descriptor_texture(desc) >= match_texture)
        return torch.where(valid, best.float(), INVALID)

    return finish(left, desc_l), finish(right, desc_r)


def warm_band_counts(
    mu_l: torch.Tensor,         # (..., W) float32 warm priors
    mu_r: torch.Tensor,
    *,
    num_disp: int,
    disp_min: int,
    warm_band: int,
) -> tuple[int, int, int]:
    """The work :func:`dense_match_rows_warm_ref` needs on these priors:
    (left-view candidates, right-view candidates, right-view candidates whose
    SAD a left-view candidate also needs).  Right pixel ``u`` at ``d`` and
    left pixel ``u + d`` at ``d`` both need SAD(L[u + d], R[u]), so the
    distinct SADs number left + right - shared.  A measurement helper for the
    kernel's bound; the scan does not use it."""
    w = mu_l.shape[-1]
    u = torch.arange(w, device=mu_l.device)
    lo_d, hi_d = float(disp_min), float(disp_min + num_disp - 1)

    def band(mu, cut):
        r = torch.round(mu)
        nan = torch.isnan(r)
        lo = torch.where(nan, 1.0, (r - warm_band).clamp(lo_d, hi_d)).to(torch.int64)
        hi = torch.where(nan, 0.0, (r + warm_band).clamp(lo_d, hi_d)).to(torch.int64)
        return lo, hi, torch.minimum(hi, cut)

    lo_l, hi_l, cut_l = band(mu_l, u)
    lo_r, _, cut_r = band(mu_r, w - 1 - u)
    shared = 0
    for k in range(min(2 * warm_band + 1, num_disp)):
        d = lo_r + k
        x = (u + d).clamp(max=w - 1)
        hit = (d <= cut_r) & (d >= lo_l.gather(-1, x)) & (d <= hi_l.gather(-1, x))
        shared += int(hit.sum())

    def count(lo, cut):
        return int((cut - lo + 1).clamp(min=0).sum())

    return count(lo_l, cut_l), count(lo_r, cut_r), shared


# --------------------------------------------------------------------------
# 3x3 stencils: Sobel and median
# --------------------------------------------------------------------------
def edge_row_views(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Edge-pad the last two axes of ``x`` (..., H, W) by one (clamped
    indices, the values of ``jnp.pad(mode="edge")``) and return the three
    row-shifted views (rows y-1, y, y+1), each (..., H, W + 2)."""
    h, w = x.shape[-2:]
    rows = torch.arange(-1, h + 1, device=x.device).clamp_(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp_(0, w - 1)
    padded = x[..., rows, :][..., cols]
    return padded[..., 0:h, :], padded[..., 1 : h + 1, :], padded[..., 2 : h + 2, :]


def sobel_rows_ref(
    top: torch.Tensor, mid: torch.Tensor, bot: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel du/dv from three row-shifted (..., W + 2) int32 views of the
    edge-padded image: (gx, gy) int8 (..., W), ``clip(g // 4, -128, 127)``
    with floor division."""
    w = top.shape[-1] - 2
    l0, c0, r0 = top[..., :w], top[..., 1 : w + 1], top[..., 2 : w + 2]
    l1, r1 = mid[..., :w], mid[..., 2 : w + 2]
    l2, c2, r2 = bot[..., :w], bot[..., 1 : w + 1], bot[..., 2 : w + 2]
    gx = (l0 + 2 * l1 + l2) - (r0 + 2 * r1 + r2)
    gy = (l0 + 2 * c0 + r0) - (l2 + 2 * c2 + r2)

    def pack(g):
        return torch.div(g, 4, rounding_mode="floor").clamp(-128, 127).to(torch.int8)

    return pack(gx), pack(gy)


def median9(vals: list) -> torch.Tensor:
    """Median of 9 elementwise tensors via Paeth's 19-op min/max network
    (value-identical to ``sort(...)[..., 4]``)."""
    if len(vals) != 9:
        raise ValueError(f"median9 needs 9 tensors, got {len(vals)}")
    v = list(vals)
    # Paeth, "Median Finding on a 3x3 Grid" (Graphics Gems).
    pairs = (
        (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7),
        (1, 2), (4, 5), (7, 8), (0, 3), (5, 8), (4, 7),
        (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4),
        (4, 2),
    )
    for i, j in pairs:
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[4]


def median3x3_rows_ref(top: torch.Tensor, mid: torch.Tensor, bot: torch.Tensor) -> torch.Tensor:
    """Valid-aware 3x3 median from three row-shifted (..., W + 2) float32
    views of the edge-padded map: invalid (-1) neighbours take the centre's
    value, and an invalid centre stays invalid."""
    w = top.shape[-1] - 2
    centre = mid[..., 1 : w + 1]
    wins = [view[..., dx : dx + w] for view in (top, mid, bot) for dx in range(3)]
    wins = [torch.where(win == INVALID, centre, win) for win in wins]
    return torch.where(centre == INVALID, INVALID, median9(wins))


# --------------------------------------------------------------------------
# Flash attention
# --------------------------------------------------------------------------
# Scores the plain attention holds at once (B x H x query rows x keys): its
# float64 steps (``fma_f32``) take 8 bytes an element each.
_FLASH_REF_SCORES = 2 ** 25


def flash_attention_ref(
    q: torch.Tensor,          # (B, H, Sq, D)
    k: torch.Tensor,          # (B, H, Skv, D)
    v: torch.Tensor,          # (B, H, Skv, D)
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Plain softmax attention in float32, cast to q's dtype -- what the
    flash kernel must match.  Each score is multiplied by the float32 scale
    1 / sqrt(D), then, with ``softcap > 0``, capped to ``softcap * tanh(s *
    (1 / softcap))`` (a multiply by the float32 reciprocal, as the jitted
    reference computes it, and :func:`tanh_f32`: XLA's tanh on the CPU; the
    kernel keeps tanhf, within its tolerance), then masked (the reference's order,
    ``repro/models/attention.py``), then normalised as ``jax.nn.softmax`` on
    XLA:CPU (:func:`xla_softmax_f32`; uncapped, the scale's multiply and the
    max's subtraction are one FMA there).  With ``causal`` a key position j
    is visible to query position i iff j <= i (both from 0), and with
    ``window > 0`` also iff i - j < window; a masked score is -1e30, not
    -inf.  Long inputs run a block of query rows at a time.  Differentiable:
    autograd through it is the flash backward's plain version."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    rows = max(1, _FLASH_REF_SCORES // max(1, b * h * skv))
    out = [_flash_rows(q[:, :, lo:lo + rows], k, v, lo, causal, window, softcap)
           for lo in range(0, sq, rows)]
    return out[0] if len(out) == 1 else torch.cat(out, 2)


def flash_lse_ref(q: torch.Tensor, k: torch.Tensor, causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """Each query row's log-sum-exp of its visible scores (scaled, capped,
    as :func:`flash_attention_ref`'s) in the log2 domain, (B * H, Sq)
    float32: what the kernel writes beside its output for the backward."""
    b, h, sq, d = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / d ** 0.5)
    if softcap > 0.0:
        s = softcap * tanh_f32(s * float(np.float32(1.0 / softcap)))
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= qpos - kpos < window
        s = s.masked_fill(~mask, float("-inf"))
    return (torch.logsumexp(s, -1) * (1.0 / math.log(2.0))).reshape(b * h, sq)


def flash_attention_bwd_ref(q, k, v, dout, causal: bool = True, window: int = 0,
                            softcap: float = 0.0):
    """(dq, dk, dv) of :func:`flash_attention_ref` for the output gradient
    ``dout``, in q's dtype: the chain autograd runs through it (the softmax's
    ``p (g - sum(g p))`` times the scale, tanh's ``1 - y^2``), written out so
    that it runs where autograd cannot record (below a custom op)."""
    scale = 1.0 / q.shape[-1] ** 0.5
    q32, k32, v32, g = q.float(), k.float(), v.float(), dout.float()
    raw = torch.einsum("bhqd,bhkd->bhqk", q32, k32)
    mask = None
    if causal:
        qpos = torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= qpos - kpos < window
    if softcap > 0.0:
        inv = float(np.float32(1.0 / softcap))
        y = tanh_f32(raw * scale * inv)
        p = _xla_softmax_values(softcap * y, 1.0, mask)
    else:
        p = _xla_softmax_values(raw, scale, mask)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v32)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    if softcap > 0.0:
        ds = ds * softcap * (1 - y * y) * inv
    ds = ds * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k32)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_rows(q, k, v, first: int, causal: bool, window: int, softcap: float):
    """:func:`flash_attention_ref` for the query rows ``first`` onwards."""
    scale = 1.0 / q.shape[-1] ** 0.5
    raw = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    mask = None
    if causal:
        qpos = first + torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= qpos - kpos < window
    if softcap > 0.0:
        s = raw * scale
        p = xla_softmax_f32(softcap * tanh_f32(s * float(np.float32(1.0 / softcap))), mask=mask)
    else:
        p = xla_softmax_f32(raw, scale, mask)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
