"""Multi-head Latent Attention, DeepSeek-V2 (counterpart of
``repro/models/mla.py`` for ``LayerKind.MLA``).

Keys and values are compressed into a rank-``kv_lora_rank`` latent ``c_kv``
plus one RoPE key ``k_rope`` shared by every head; the decode cache holds
only those two, with no head axis.  Queries come from ``w_q``, or through
their own low-rank bottleneck ``w_dq`` -> ``w_uq`` when ``q_lora_rank > 0``
(deepseek-v2-236b).

Both attention computations are plain PyTorch, as the reference's are plain
JAX (no Pallas kernel):

- decode (one token with a cache) is the reference's absorbed form: the
  query is projected into latent space through ``w_uk``, scored against the
  cache's ``c_kv`` and ``k_rope`` directly (the two scores, each rounded to
  the model's dtype, added and scaled in float32), softmax in float32, the
  readout taken in latent space and expanded through ``w_uv``;
- the forward without a cache and prefill expand ``c_kv`` to per-head keys
  and values and attend over the packed ``nope + rope`` head, causally, the
  queries at ``cache.index`` onwards over the whole cache (this is correct
  in the reference's MLA, unlike GQA prefill at a non-zero index).  The
  reference's blockwise online softmax and its V padded to the packed width
  give the same function; this single-pass softmax differs from it in
  float32's last bits.

The flash kernel takes head widths 16/32/64/128 only, and MLA's packed head
is nope + rope = 192 wide with V of 128 (ROADMAP.md, queue 2).

The cache holds bfloat16 by default, as the reference's; a float32 model
reads it back as float32.  As the port's ``KVCache``, new entries are
written into the buffers in place.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.models import common
from repro_torch.models.attention import cache_insert
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class MLACache:
    c_kv: torch.Tensor    # (B, Smax, R)
    k_rope: torch.Tensor  # (B, Smax, Dr)
    index: int            # number of valid positions


def mla_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The port's matrices: the reference's (in, H, k) tensors as (in, H*k)
    and its (H, dv, d) output projection as (H*dv, d)."""
    mla = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    r, dn, dr, dv = mla.kv_lora_rank, mla.nope_head_dim, mla.rope_head_dim, mla.v_head_dim
    shapes = {"w_dkv": (d, r), "w_kr": (d, dr), "w_uk": (r, h * dn), "w_uv": (r, h * dv),
              "w_o": (h * dv, d)}
    if mla.q_lora_rank > 0:
        shapes.update(w_dq=(d, mla.q_lora_rank), w_uq=(mla.q_lora_rank, h * (dn + dr)))
    else:
        shapes["w_q"] = (d, h * (dn + dr))
    return shapes


def mla_param_specs(cfg: ModelConfig) -> dict:
    """Logical axes per parameter in the port's layout: the reference's
    (in, H, k) tensors' ("fsdp", "heads", None) is ("fsdp", "heads") on
    (in, H*k) and its w_o's ("heads", None, "fsdp") is ("heads", "fsdp")
    on (H*dv, d), the heads major in each merged dimension."""
    specs = {
        "w_dkv": ("fsdp", None),
        "w_kr": ("fsdp", None),
        "w_uk": ("fsdp", "heads"),
        "w_uv": ("fsdp", "heads"),
        "w_o": ("heads", "fsdp"),
    }
    if cfg.mla.q_lora_rank > 0:
        specs["w_dq"] = ("fsdp", None)
        specs["w_uq"] = ("fsdp", "heads")
    else:
        specs["w_q"] = ("fsdp", "heads")
    return specs


def init_mla_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """float32 weights in the port's layout, drawn as the reference's: the
    fan-in of ``w_uk``, ``w_uv`` and ``w_uq`` is their first axis (R, or the
    query rank), of ``w_o`` (H, dv, d) it is H."""
    mla = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    r, dn, dr, dv = mla.kv_lora_rank, mla.nope_head_dim, mla.rope_head_dim, mla.v_head_dim
    full = {"w_dkv": (d, r), "w_kr": (d, dr), "w_uk": (r, h, dn), "w_uv": (r, h, dv),
            "w_o": (h, dv, d)}
    if mla.q_lora_rank > 0:
        full.update(w_dq=(d, mla.q_lora_rank), w_uq=(mla.q_lora_rank, h, dn + dr))
    else:
        full["w_q"] = (d, h, dn + dr)
    shapes = mla_shapes(cfg)
    return {name: common.dense_init(gen, shape, device=device).reshape(shapes[name])
            for name, shape in full.items()}


def _queries(params, x: torch.Tensor, cfg: ModelConfig):
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr)), before RoPE."""
    mla = cfg.mla
    b, s, _ = x.shape
    if mla.q_lora_rank > 0:
        q = (x @ params["w_dq"]) @ params["w_uq"]
    else:
        q = x @ params["w_q"]
    q = q.view(b, s, cfg.num_heads, mla.nope_head_dim + mla.rope_head_dim)
    return q[..., :mla.nope_head_dim], q[..., mla.nope_head_dim:]


def _decode(params, q_nope, q_rope, c_kv, k_rope, cfg: ModelConfig) -> torch.Tensor:
    """The absorbed form for one query a sequence: q_nope (B, H, dn) and
    q_rope (B, H, dr) against the cache's valid prefix c_kv (B, n, R) and
    k_rope (B, n, dr), all in the model's dtype -> (B, H, dv)."""
    mla = cfg.mla
    h, r = cfg.num_heads, mla.kv_lora_rank
    w_uk = params["w_uk"].view(r, h, mla.nope_head_dim).permute(1, 2, 0)     # (H, dn, R)
    q_lat = (q_nope.transpose(0, 1) @ w_uk).transpose(0, 1)                   # (B, H, R)
    s_lat = q_lat @ c_kv.transpose(1, 2)                                      # (B, H, n)
    s_rope = q_rope @ k_rope.transpose(1, 2)
    scale = 1.0 / math.sqrt(mla.nope_head_dim + mla.rope_head_dim)
    # XLA adds the two bf16 scores in float32 and keeps the sum unrounded
    # (excess precision: the add's bf16 round trip before the cast goes).
    # Its softmax (kernels/ref.py::xla_softmax_f32) is not copied: ~200 small
    # kernels a layer on the card, for last bits that the bf16 readout rounds
    # away (tests/test_torch_bf16_decode_layers.py).
    p = torch.softmax((s_lat.float() + s_rope.float()) * scale, dim=-1)
    o_lat = p.to(c_kv.dtype) @ c_kv                                           # (B, H, R)
    w_uv = params["w_uv"].view(r, h, mla.v_head_dim).transpose(0, 1)         # (H, R, dv)
    return (o_lat.transpose(0, 1) @ w_uv).transpose(0, 1)                     # (B, H, dv)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int) -> torch.Tensor:
    """Causal attention of q (B, Sq, H, Dqk) at positions q_offset.. over k
    (B, Skv, H, Dqk) and v (B, Skv, H, Dv) at positions 0.., in float32 ->
    (B, Sq, H, Dv) in q's dtype."""
    sq, skv = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)
    hidden = torch.arange(skv, device=q.device)[None, :] > q_pos[:, None]
    p = torch.softmax(scores.masked_fill(hidden, float("-inf")), dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, v.float()).to(q.dtype)


def mla_block(
    params,
    x: torch.Tensor,              # (B, S, D)
    positions: torch.Tensor,      # (B, S)
    cfg: ModelConfig,
    cache: Optional[MLACache] = None,
) -> tuple[torch.Tensor, Optional[MLACache]]:
    """Returns (out (B, S, D), updated cache)."""
    mla = cfg.mla
    dtype = x.dtype
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.num_heads, mla.nope_head_dim, mla.rope_head_dim, mla.v_head_dim

    q_nope, q_rope = _queries(params, x, cfg)
    q_rope = common.apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = x @ params["w_dkv"]                                               # (B, S, R)
    k_rope = common.apply_rope((x @ params["w_kr"])[:, :, None, :], positions,
                               cfg.rope_theta)[:, :, 0]                      # (B, S, dr)

    if cache is not None:
        n = cache.index + s
        cache_insert(cache.c_kv, c_kv, cache.index, cfg.cache_update)
        cache_insert(cache.k_rope, k_rope, cache.index, cfg.cache_update)
        new_cache = MLACache(c_kv=cache.c_kv, k_rope=cache.k_rope, index=n)
        # attend over what the cache holds (its dtype's roundings), as the reference
        c_kv, k_rope = cache.c_kv[:, :n].to(dtype), cache.k_rope[:, :n].to(dtype)
    else:
        new_cache = None

    if cache is not None and s == 1:
        out = _decode(params, q_nope[:, 0], q_rope[:, 0], c_kv, k_rope, cfg)[:, None]
    else:
        skv = c_kv.shape[1]
        k_nope = (c_kv @ params["w_uk"]).view(b, skv, h, dn)
        v = (c_kv @ params["w_uv"]).view(b, skv, h, dv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, skv, h, dr)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        # Local to each batch row and head: on local shards under a mesh
        # (DTensor cannot take the reshapes of the einsums' backward there).
        heads = ("batch", None, "heads", None)
        attend = functools.partial(_attend, q_offset=0 if cache is None else cache.index)
        out = sharding.on_local_shards(attend, (heads,) * 3, heads)(q, k, v)

    y = out.reshape(b, s, h * dv) @ params["w_o"]
    return common.with_logical(y, "batch", "seq", None), new_cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> MLACache:
    mla = cfg.mla
    return MLACache(
        c_kv=torch.zeros((batch, max_len, mla.kv_lora_rank), dtype=dtype, device=device),
        k_rope=torch.zeros((batch, max_len, mla.rope_head_dim), dtype=dtype, device=device),
        index=0)
