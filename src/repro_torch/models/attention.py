"""Attention: GQA with RoPE or M-RoPE, gemma2's softcap and sliding window,
and a KV cache (counterpart of ``repro/models/attention.py`` for
``LayerKind.ATTN`` and ``LayerKind.ATTN_LOCAL``).

Both attention computations go to the hand-written flash kernel
(:func:`repro_torch.kernels.flash_attention.flash_attention`), which runs its
plain version on CPU tensors and launches ``csrc/flash_attention.cu`` on CUDA
tensors, with no fallback between the two.  The kernel caps each scaled
score at ``cfg.attn_softcap`` (when > 0) before the mask, as the reference:

- a full sequence from position 0 (the forward without a cache, and prefill
  into an empty cache; the reference's ``blockwise_attention``) is one causal
  call, with ``window=cfg.sliding_window`` on ``ATTN_LOCAL`` layers (row i
  sees keys i - window + 1 .. i);
- decode (one query against the cache; the reference's ``decode_attention``)
  is one call, ``causal=False``, over the cache's valid prefix or, on an
  ``ATTN_LOCAL`` layer, its last ``window`` positions ``[max(0, n - window),
  n)``: the reference's ``kv_pos > index - 1 - window``.

The KV heads are expanded to the query heads first (the kernel has no
grouped-query layout): KV head j serves query heads ``j*g .. j*g + g - 1``,
as ``jnp.repeat`` on the head axis does.  The kernel takes head widths 16,
32, 64 and 128 on the card and raises for any other.

The cache holds bfloat16 whatever the model's dtype (as the reference's
``init_caches``); a float32 model reads it back as float32 (the float32
kernel).  Unlike the reference, the port writes new keys and values into the
cache's buffers in place and returns a :class:`KVCache` with the advanced
index over the same buffers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import common
from repro_torch.models.config import LayerKind, ModelConfig


# The layer kinds this module computes: global and sliding-window attention.
ATTN_KINDS = (LayerKind.ATTN, LayerKind.ATTN_LOCAL)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor       # (B, Smax, KV, D)
    v: torch.Tensor       # (B, Smax, KV, D)
    index: int            # number of valid positions


def attn_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The port's matrices: the reference's (d, H, hd) projections as
    (d, H*hd) and its (H, hd, d) output projection as (H*hd, d)."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, kvh * hd), "wv": (d, kvh * hd), "wo": (h * hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(h * hd,), bk=(kvh * hd,), bv=(kvh * hd,))
    return shapes


def attn_param_specs(cfg: ModelConfig) -> dict:
    """Logical axes per parameter, in the port's layout (resolved by the
    sharding rules).  The reference's ("fsdp", "heads", None) on (d, H, hd)
    is ("fsdp", "heads") on (d, H*hd): the heads are the major part of the
    merged dimension, so a heads shard of the matrix is the reshape of the
    reference's shard.  The FSDP axis rides on d_model (a non-TP dim), so
    ZeRO-3 and TP compose."""
    specs = {
        "wq": ("fsdp", "heads"),
        "wk": ("fsdp", "kv_heads"),
        "wv": ("fsdp", "kv_heads"),
        "wo": ("heads", "fsdp"),
    }
    if cfg.qkv_bias:
        specs["bq"] = ("heads",)
        specs["bk"] = ("kv_heads",)
        specs["bv"] = ("kv_heads",)
    return specs


def init_attn_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """float32 weights in the port's layout, drawn as the reference's: the
    fan-in of ``wo`` (H, hd, d) is H."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    params = {
        "wq": common.dense_init(gen, (d, h, hd), device=device),
        "wk": common.dense_init(gen, (d, kvh, hd), device=device),
        "wv": common.dense_init(gen, (d, kvh, hd), device=device),
        "wo": common.dense_init(gen, (h, hd, d), device=device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", kvh), ("bv", kvh)):
            params[name] = torch.zeros((n, hd), dtype=torch.float32, device=device)
    shapes = attn_shapes(cfg)
    return {name: w.reshape(shapes[name]) for name, w in params.items()}


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    # Each merged head dimension takes its heads' layout before it is split
    # into (heads, hd): DTensor cannot unflatten a dimension whose shards
    # cut through a head (a matmul may shard the output columns of a
    # replicated weight), where GSPMD would reshard.  No-ops without a mesh.
    q = common.with_logical(q, "batch", "seq", "heads")
    k, v = (common.with_logical(t, "batch", "seq", "kv_heads") for t in (k, v))
    hd = cfg.head_dim
    return (q.view(b, s, cfg.num_heads, hd), k.view(b, s, cfg.num_kv_heads, hd),
            v.view(b, s, cfg.num_kv_heads, hd))


def _apply_pos(q, k, positions, cfg: ModelConfig):
    """RoPE (on the first stream of (B, S, 3) positions) or M-RoPE (which
    needs them); sinusoidal positions are added at the embedding, and
    ``none`` has none."""
    if cfg.pos_embedding == "rope":
        pos = positions if positions.dim() == 2 else positions[..., 0]
        q = common.apply_rope(q, pos, cfg.rope_theta)
        k = common.apply_rope(k, pos, cfg.rope_theta)
    elif cfg.pos_embedding == "mrope":
        if positions.dim() != 3:
            raise ValueError(f"mrope needs (B, S, 3) positions, got {tuple(positions.shape)}")
        q = common.apply_mrope(q, positions, cfg.rope_theta)
        k = common.apply_mrope(k, positions, cfg.rope_theta)
    return q, k


def _expand_kv(k: torch.Tensor, num_heads: int, from_cache: bool = False) -> torch.Tensor:
    """(B, S, KV, D) -> (B, H, S, D), contiguous: KV head j serves query
    heads j*g .. j*g + g - 1 (``jnp.repeat`` on the head axis), so a shard
    of KV heads owns exactly its own expanded heads.  The reference's hint
    keeps a cache's layout (its sequence on "seq_kv", the expanded heads on
    "kv_heads") and puts a fresh sequence's on "heads"."""
    k = k.transpose(1, 2)
    kvh = k.shape[1]
    if kvh == num_heads:
        return k.contiguous()
    k = k.repeat_interleave(num_heads // kvh, dim=1)
    if from_cache:
        return common.with_logical(k, "batch", "kv_heads", "seq_kv", None)
    return common.with_logical(k, "batch", "heads", "seq", None)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int = 0, softcap: float = 0.0, from_cache: bool = False) -> torch.Tensor:
    """q (B, Sq, H, D), k and v (B, Skv, KV, D) in q's dtype -> (B, Sq, H, D)
    through the flash kernel.  Under a mesh (DTensor inputs) the kernel runs
    on each rank's local shards, its backward too: q, k, v and the output
    laid out (B, H, S, D) by "batch" and "heads".  The kernel attends each
    query row over every key of its head, so the sequence dimensions are
    gathered wherever the rules split them (``seq_kv`` in long decode), and
    k and v take q's split of the heads (a local slice where the KV heads
    replicate): explicit redistributes, no-ops where the layouts agree."""
    h = q.shape[2]
    flash = functools.partial(flash_attention, causal=causal, window=window, softcap=softcap)
    bhsd = ("batch", "heads", None, None)
    out = sharding.on_local_shards(flash, (bhsd,) * 3, bhsd)(
        q.transpose(1, 2), _expand_kv(k, h, from_cache), _expand_kv(v, h, from_cache))
    return out.transpose(1, 2)


def decode_span(n: int, window: int) -> tuple[int, int]:
    """The cache positions [lo, n) that a decode query at position n - 1
    attends over: the valid prefix, or with ``window > 0`` its last
    ``window`` positions (the reference's ``kv_pos > index - 1 - window``)."""
    return (max(0, n - window) if window > 0 else 0), n


def cache_insert(buf: torch.Tensor, new: torch.Tensor, idx: int, mode: str = "dus") -> torch.Tensor:
    """Write ``new`` (B, S_new, ...) into ``buf`` (B, S, ...) at ``idx``, in
    place, cast to the buffer's dtype.  ``mode`` is the reference's
    ``cache_update``: "dus" writes the slice; "onehot" (one new position)
    rewrites the whole buffer as ``where(iota == idx, new, buf)``, an
    elementwise update that keeps a buffer split along its sequence where it
    is (DTensor gathers a sharded dimension to slice it)."""
    if idx + new.shape[1] > buf.shape[1]:
        raise ValueError(f"cache of {buf.shape[1]} positions cannot take {new.shape[1]} "
                         f"at index {idx}")
    if mode not in ("dus", "onehot"):
        raise ValueError(f"cache_update must be 'dus' or 'onehot', got {mode!r}")
    if mode == "onehot" and new.shape[1] == 1:
        sel = (torch.arange(buf.shape[1], device=buf.device) == idx).view(
            1, buf.shape[1], *(1,) * (buf.dim() - 2))
        buf.copy_(torch.where(sel, new.to(buf.dtype), buf))
        return buf
    split = sharding.placements_split(buf, 1)
    if split is None:
        buf[:, idx:idx + new.shape[1]] = new.to(buf.dtype)
        return buf
    # A sequence split over ranks: DTensor would slice a gathered copy, and the
    # write would miss the buffer.  Gather, write, lay out again (what GSPMD
    # does for the reference's dynamic_update_slice there).
    whole = buf.redistribute(buf.device_mesh, split)
    whole[:, idx:idx + new.shape[1]] = new.to(buf.dtype)
    buf.copy_(whole.redistribute(buf.device_mesh, buf.placements))
    return buf


def attention_block(
    params,
    x: torch.Tensor,              # (B, S, D)
    positions: torch.Tensor,      # (B, S) or (B, S, 3)
    cfg: ModelConfig,
    kind: LayerKind,
    cache: Optional[KVCache] = None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention with optional cache. Returns (out, updated_cache)."""
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"{kind.value} is not GQA attention")
    window = cfg.sliding_window if kind == LayerKind.ATTN_LOCAL else 0
    cap = cfg.attn_softcap
    q, k, v = _project_qkv(params, x, cfg)
    q = common.with_logical(q, "batch", "seq", "heads", None)
    k = common.with_logical(k, "batch", "seq", "kv_heads", None)
    q, k = _apply_pos(q, k, positions, cfg)
    b, s = x.shape[:2]

    if cache is None:
        out = _attend(q, k, v, causal=True, window=window, softcap=cap)
        new_cache = None
    elif s == 1:
        # decode: insert the token at cache.index, attend over the valid
        # prefix, or over its last `window` positions.
        lo, n = decode_span(cache.index + 1, window)
        cache_insert(cache.k, k, cache.index, cfg.cache_update)
        cache_insert(cache.v, v, cache.index, cfg.cache_update)
        out = _attend(q, cache.k[:, lo:n].to(q.dtype), cache.v[:, lo:n].to(q.dtype),
                      causal=False, softcap=cap, from_cache=True)
        new_cache = KVCache(k=cache.k, v=cache.v, index=n)
    elif cache.index == 0:
        # prefill into an empty cache.
        cache_insert(cache.k, k, 0)
        cache_insert(cache.v, v, 0)
        out = _attend(q, k, v, causal=True, window=window, softcap=cap)
        new_cache = KVCache(k=cache.k, v=cache.v, index=s)
    else:
        # The reference's prefill at index > 0 attends over the new tokens
        # only and counts their key positions from 0 (attention.py:334-352);
        # no caller of the reference reaches it, and the port does not
        # reproduce it.
        raise NotImplementedError(
            f"prefill of {s} tokens into a cache at index {cache.index}: the reference "
            f"attends over the new tokens only, counting key positions from 0 "
            f"(ROADMAP.md, queue 3)")

    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim) @ params["wo"]
    return common.with_logical(out, "batch", "seq", None), new_cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), index=0)
