"""Roofline analysis of the dry run's cells on the H100 (counterpart of
``repro/analysis/roofline.py``, whose figures are TPU v5e's).

Three terms per (arch x shape x mesh):

    compute    = FLOPs / (chips * 989e12 bf16 FLOP/s)
    memory     = HBM bytes / (3.35e12 B/s)                 (bytes per device)
    collective = collective bytes / (chips * 50e9 B/s a link)

The figures: the H100 SXM's dense bf16 tensor-core peak and its HBM3 rate,
as ``chip_smoke.py`` cites them for the kernels' bounds; the link is the
slowest one a collective of the production meshes crosses.  NVLink 4 moves
450 GB/s a direction between the 8 cards of a node, but every mesh axis
spans nodes (the "model" axis of 16 spans two 8-card nodes, "data" and
"pod" span more), and across nodes a card has one 400 Gb/s NDR link: 50
GB/s.  The collective term is a model, not a measurement: no mesh of more
than one card is measured.

The FLOPs and HBM bytes are the reference's analytic model (the terms use
it; the dry run's own per-device count is ``hlo_flops``).  Two departures
from the reference, both deliberate:

- **Trip counts.**  XLA's cost analysis counts a loop body once, so the
  reference multiplies the collective bytes by ``microbatches x units``.
  The port's dry run runs Python loops: its collective bytes are already
  whole-step totals, and are not multiplied again.
- **Causal attention.**  The reference charges blockwise attention the full
  S x S grid unless ``causal_skip`` is set.  The port's flash kernels never
  visit a fully masked tile, so its GQA layers are charged the causal
  context whatever ``causal_skip`` says; MLA's prefill is plain PyTorch over
  the whole score matrix in the port, so it is charged the full grid.
"""
from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.configs.shapes import SHAPES
from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.models.xlstm import MLSTM_CHUNK, MLSTM_HEADS, SLSTM_HEADS

PEAK_FLOPS = 989e12          # bf16 / card (dense, tensor cores)
HBM_BW = 3.35e12             # B/s / card
LINK_BW = 50e9               # B/s / card across nodes (400 Gb/s NDR)
NVLINK_BW = 450e9            # B/s a direction within an 8-card node (not used by the terms)

# The layers the port runs on its flash kernels, which skip masked tiles.
_FLASH_KINDS = (LayerKind.ATTN, LayerKind.ATTN_LOCAL)
_ATTN_KINDS = (LayerKind.ATTN, LayerKind.ATTN_LOCAL, LayerKind.MLA)


# --------------------------------------------------------------------------
# analytic FLOPs
# --------------------------------------------------------------------------
def _attn_flops_per_token(cfg: ModelConfig, kind: LayerKind, context: int) -> float:
    """Score+readout FLOPs per query token for one attention layer."""
    if kind == LayerKind.ATTN_LOCAL:
        context = min(context, cfg.sliding_window)
    h, hd = cfg.num_heads, cfg.head_dim
    if kind == LayerKind.MLA:
        hd = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
    return 2.0 * 2.0 * h * hd * context     # QK^T + PV, 2 FLOPs/MAC


def _mixer_state_flops_per_token(cfg: ModelConfig, kind: LayerKind) -> float:
    """Sequence-mixer state update FLOPs per token (mamba/xlstm)."""
    if kind == LayerKind.MAMBA:
        d_in = cfg.mamba.expand * cfg.d_model
        n = cfg.mamba.d_state
        return 2.0 * d_in * n * 3 + 2.0 * d_in * cfg.mamba.d_conv
    if kind == LayerKind.MLSTM:
        d_inner = 2 * cfg.d_model
        dh = d_inner // MLSTM_HEADS
        # chunkwise: intra-chunk quadratic (~chunk per token) + state readout
        return 2.0 * d_inner * (MLSTM_CHUNK + 2 * dh)
    if kind == LayerKind.SLSTM:
        dh = cfg.d_model // SLSTM_HEADS
        return 2.0 * SLSTM_HEADS * dh * 4 * dh
    return 0.0


def _executed_context(kind: LayerKind, seq: int) -> int:
    """The context the port's attention computes per query token: the causal
    half on the flash kernels, which skip masked tiles; all ``seq`` in MLA's
    plain scores, which mask the whole grid, ``causal_skip`` or not."""
    return seq // 2 if kind in _FLASH_KINDS else seq


def analytic_flops(cfg: ModelConfig, shape_name: str) -> dict:
    """Returns {model_flops, executed_flops} TOTAL across chips, one step."""
    spec = SHAPES[shape_name]
    b, s = spec.global_batch, spec.seq_len
    n_active = cfg.active_param_count()
    causal_ctx = s // 2

    if spec.mode == "train":
        tokens = b * s
        base = 6.0 * n_active * tokens               # 2 fwd + 4 bwd
        attn_model, attn_exec = 0.0, 0.0
        for kind in cfg.layer_kinds:
            if kind in _ATTN_KINDS:
                attn_model += tokens * _attn_flops_per_token(cfg, kind, causal_ctx) * 3
                attn_exec += tokens * _attn_flops_per_token(
                    cfg, kind, _executed_context(kind, s)) * 3
            else:
                m = tokens * _mixer_state_flops_per_token(cfg, kind) * 3
                attn_model += m
                attn_exec += m
        model = base + attn_model
        policy = getattr(cfg, "remat_policy", "nothing")
        if policy == "nothing":
            # full forward recompute in backward
            recompute = 2.0 * n_active * tokens + attn_exec / 3.0
        elif policy == "names":
            # mixer/MLP outputs saved: recompute projections only (~40% fwd)
            recompute = 0.8 * n_active * tokens
        else:                                        # dots: nearly free bwd
            recompute = 0.2 * n_active * tokens
        executed = base + attn_exec + recompute
        return {"model_flops": model, "executed_flops": executed}

    if spec.mode == "prefill":
        tokens = b * s
        base = 2.0 * n_active * tokens
        attn_model, attn_exec = 0.0, 0.0
        for kind in cfg.layer_kinds:
            if kind in _ATTN_KINDS:
                attn_model += tokens * _attn_flops_per_token(cfg, kind, causal_ctx)
                attn_exec += tokens * _attn_flops_per_token(
                    cfg, kind, _executed_context(kind, s))
            else:
                m = tokens * _mixer_state_flops_per_token(cfg, kind)
                attn_model += m
                attn_exec += m
        return {"model_flops": base + attn_model,
                "executed_flops": base + attn_exec}

    # decode: one token per sequence against a cache of depth s
    tokens = b * 1
    base = 2.0 * n_active * tokens
    attn = 0.0
    for kind in cfg.layer_kinds:
        if kind in _ATTN_KINDS:
            attn += tokens * _attn_flops_per_token(cfg, kind, s)
        else:
            attn += tokens * _mixer_state_flops_per_token(cfg, kind)
    return {"model_flops": base + attn, "executed_flops": base + attn}


# --------------------------------------------------------------------------
# analytic HBM bytes
# --------------------------------------------------------------------------
def analytic_bytes(cfg: ModelConfig, shape_name: str, devices: int,
                   microbatches: int = 1) -> float:
    """HBM bytes PER DEVICE per step (coarse, documented model).

    train: each microbatch reads the local param shard (bf16 compute copy) and
    writes/reads gradient + optimizer state once per step; activations are
    written+read once per microbatch (remat recomputes instead of storing).
    serve: params read once + cache read/write.
    """
    spec = SHAPES[shape_name]
    n = cfg.param_count()
    p_local = n / devices
    if spec.mode == "train":
        b, s = spec.global_batch, spec.seq_len
        tokens_local = b * s / devices
        act = tokens_local * cfg.d_model * 2 * 2 * len(cfg.layer_kinds) / max(
            len(cfg.pattern_unit), 1
        )  # one residual checkpoint per unit per microbatch, bf16 rw
        return (
            microbatches * p_local * 2 * 2        # param shard read fwd+bwd (bf16)
            + p_local * (4 + 4 + 4 + 4)           # grads rw + m/v rw (fp32-ish)
            + act * 2
        )
    if spec.mode == "prefill":
        b, s = spec.global_batch, spec.seq_len
        tokens_local = b * s / devices
        cache = _cache_bytes(cfg, b, s) / devices
        return p_local * 2 + cache + tokens_local * cfg.d_model * 2 * 4
    # decode
    b, s = spec.global_batch, spec.seq_len
    cache = _cache_bytes(cfg, b, s) / devices
    return p_local * 2 + cache                     # read whole cache + params


def _cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> float:
    """Bytes of every layer's decode cache or recurrent state: bfloat16 keys
    and values (GQA), latents and RoPE keys (MLA); float32 states (Mamba,
    mLSTM, sLSTM).  ``launch/mesh.py::make_rules`` reads it to budget the
    optimised serving layout."""
    total = 0.0
    for kind in cfg.layer_kinds:
        if kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
            total += 2 * batch * max_len * cfg.num_kv_heads * cfg.head_dim * 2
        elif kind == LayerKind.MLA:
            total += batch * max_len * (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) * 2
        elif kind == LayerKind.MAMBA:
            d_in = cfg.mamba.expand * cfg.d_model
            total += batch * d_in * (cfg.mamba.d_state + cfg.mamba.d_conv) * 4
        elif kind == LayerKind.MLSTM:
            d_inner = 2 * cfg.d_model
            dh = d_inner // MLSTM_HEADS
            total += batch * MLSTM_HEADS * (dh * dh + dh) * 4
        elif kind == LayerKind.SLSTM:
            total += batch * cfg.d_model * 4 * 4
    return total


# --------------------------------------------------------------------------
# term assembly
# --------------------------------------------------------------------------
@dataclasses.dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops: float
    flops_ratio: float           # MODEL_FLOPS / executed (useful fraction)
    roofline_fraction: float     # compute_s / max(all terms)
    note: str = ""

    def as_row(self) -> str:
        return (
            f"| {self.arch} | {self.shape} | {self.mesh} | "
            f"{self.compute_s*1e3:.1f} | {self.memory_s*1e3:.1f} | "
            f"{self.collective_s*1e3:.1f} | {self.dominant} | "
            f"{self.flops_ratio:.2f} | {self.roofline_fraction:.2f} |"
        )


def _microbatches(record: dict, shape_name: str) -> int:
    spec = SHAPES[shape_name]
    if spec.mode != "train":
        return 1
    batch_shards = 1
    rules_batch = record.get("rules", {}).get("batch") or []
    mesh_sizes = {"pod": 2, "data": 16, "model": 16}
    for ax in rules_batch:
        batch_shards *= mesh_sizes.get(ax, 1)
    return max(1, spec.global_batch // max(batch_shards, 1))


def roofline_terms(record: dict, cfg: ModelConfig) -> RooflineResult:
    """Derive the three terms from a dry-run record + analytic model."""
    devices = record["devices"]
    shape_name = record["shape"]

    flops = analytic_flops(cfg, shape_name)
    microbatches = _microbatches(record, shape_name)

    compute_s = flops["executed_flops"] / (devices * PEAK_FLOPS)
    mem_bytes = analytic_bytes(cfg, shape_name, devices, microbatches)
    memory_s = mem_bytes / HBM_BW

    # collectives: the dry run's whole-step totals (no trip-count scaling:
    # the port's loops ran every iteration), over the inter-node link.
    coll = record.get("collectives", {})
    coll_bytes = sum(v for k, v in coll.items() if k != "count")
    collective_s = coll_bytes / (devices * LINK_BW)

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total = max(terms.values())
    # roofline fraction: time the USEFUL flops would take at peak, over the
    # bottleneck term -- 1.0 means every cycle is a model flop at the HW
    # ceiling.  For bandwidth-bound cells the ceiling is the minimal-traffic
    # memory time, so the fraction reads as memory-roofline occupancy.
    useful_s = flops["model_flops"] / (devices * PEAK_FLOPS)
    if dominant == "compute":
        fraction = useful_s / max(total, 1e-30)
    else:
        fraction = memory_s / max(total, 1e-30)
    return RooflineResult(
        arch=record["arch"],
        shape=shape_name,
        mesh=record["mesh"],
        devices=devices,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=flops["model_flops"],
        hlo_flops=record.get("flops", 0.0),
        flops_ratio=flops["model_flops"] / max(flops["executed_flops"], 1.0),
        roofline_fraction=min(1.0, fraction),
    )


def load_records(results_dir: str) -> list[dict]:
    out = []
    for root, _, files in os.walk(results_dir):
        for f in sorted(files):
            if f.endswith(".json"):
                with open(os.path.join(root, f)) as fh:
                    out.append(json.load(fh))
    return out
