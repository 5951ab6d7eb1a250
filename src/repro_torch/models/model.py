"""LMModel: one decoder covering every architecture of the reference
(counterpart of ``repro/models/model.py``: yi, qwen2.5, mistral-large, gemma2,
deepseek-v2, jamba, xlstm, qwen2-vl, musicgen).

An attention layer is RMSNorm -> attention (GQA, global or a sliding window
on ``ATTN_LOCAL``; multi-head latent attention on ``MLA``) -> residual;
RMSNorm -> MLP, or static-capacity MoE where ``_layer_is_moe`` -> residual,
with gemma2's post-block RMSNorms on the attention and MLP outputs when
``cfg.post_block_norm``.  A Mamba layer is RMSNorm -> the Mamba mixer ->
residual, then, as the reference's, RMSNorm -> MoE where ``_layer_is_moe``,
else a dense MLP when ``cfg.d_ff > 0`` -> residual.  An ``MLSTM`` or
``SLSTM`` layer is RMSNorm -> the xLSTM block -> residual, with no MLP (the
sLSTM block carries its own FFN).  The layers are a ``ModuleList``, run one
after another in ``cfg.layer_kinds``'s order (the reference scans over
stacked units).  gemma2's other options: the embedding scaled by
sqrt(d_model) (cast to the model's dtype first, as the reference), tied
embeddings (logits against ``embed``, no ``lm_head``), and the attention and
logit softcaps.  The weights are held in ``cfg.dtype``, cast once (the
reference keeps float32 and casts at every use, which gives the same
values); the RMSNorm scales, the MoE router, the Mamba mixer's conv taps,
biases, A and skip, and the xLSTM blocks' conv taps, gate biases and
recurrent gates stay float32.  The stub frontends (qwen2-vl's vision,
musicgen's audio) take precomputed embeddings (B, S, d_model) in place of
token ids; musicgen adds sinusoidal positions to its inputs and qwen2-vl's
attention rotates by M-RoPE's three position streams, (B, S, 3) positions.
``loss`` is the reference's training objective, on the module's weights or
on a dict of named tensors in their place (``torch.func.functional_call``):
the trainer differentiates it with respect to such a dict, so the module's
own parameters never require gradients and serving builds no graph.

Sharding: ``param_specs`` and ``cache_specs`` give every parameter and
cache tensor its logical axes, in the port's layout (the reference's
stacked ``units`` axis, "layers", has no counterpart: the layers are
unstacked).  :func:`shard_model` lays the parameters out on a DeviceMesh
as DTensors; under ``use_mesh`` and ``use_rules`` (``distributed.sharding``)
``apply`` lays its inputs out by "batch", ``init_caches`` lays the caches
out by their specs, and the activations are redistributed at the
reference's ``with_logical`` hints.  Plain tensors made inside the model
(positions, masks, constants) count as replicated there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, distribute_tensor
from torch.distributed.tensor.experimental import local_map

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.models import attention, common, mamba, mla, moe as moe_mod, xlstm
from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.models.mlp import init_mlp_params, mlp_block, mlp_param_specs, mlp_shapes

# One attention.KVCache, mla.MLACache, mamba.MambaState, xlstm.MLSTMState or
# xlstm.SLSTMState per layer.
Caches = list


class _Mixer(NamedTuple):
    """A recurrent mixer's module functions."""
    shapes: Callable          # cfg -> {name: shape}
    float32: tuple            # the names held in float32
    init: Callable            # (gen, cfg, device) -> float32 weights
    block: Callable           # (params, x, cfg, state) -> (out, new state)
    state: Callable           # (cfg, batch, device) -> a fresh state
    specs: Callable           # cfg -> {name: logical axes}


_MIXERS = {
    LayerKind.MAMBA: _Mixer(mamba.mamba_shapes, mamba.FLOAT32, mamba.init_mamba_params,
                            mamba.mamba_block, mamba.init_mamba_state,
                            mamba.mamba_param_specs),
    LayerKind.MLSTM: _Mixer(xlstm.mlstm_shapes, xlstm.FLOAT32, xlstm.init_mlstm_params,
                            xlstm.mlstm_block, xlstm.init_mlstm_state,
                            xlstm.mlstm_param_specs),
    LayerKind.SLSTM: _Mixer(xlstm.slstm_shapes, xlstm.FLOAT32, xlstm.init_slstm_params,
                            xlstm.slstm_block, xlstm.init_slstm_state,
                            xlstm.slstm_param_specs),
}


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def _params(shapes: dict, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({name: _param(shape, dtype, device) for name, shape in shapes.items()})


def _layer_is_moe(cfg: ModelConfig, layer_idx: int) -> bool:
    """Whether layer ``layer_idx`` (its index in the whole stack) is MoE: the
    first ``first_dense`` layers are dense (``ModelConfig.layer_is_moe``
    ignores them)."""
    if cfg.moe is None:
        return False
    if layer_idx < cfg.moe.first_dense:
        return False
    return ((layer_idx - cfg.moe.first_dense) % cfg.moe.every) == cfg.moe.offset


def _starts_unit(cfg: ModelConfig, index: int) -> bool:
    """Whether layer ``index`` is the first of one of the repeated units."""
    return index >= len(cfg.prefix) and (index - len(cfg.prefix)) % len(cfg.pattern_unit) == 0


def _layer_specs(cfg: ModelConfig, kind: LayerKind, layer_idx: int) -> dict:
    """Logical axes of one layer's parameters, named as its module's."""
    mlp = (moe_mod.moe_param_specs(cfg.moe) if _layer_is_moe(cfg, layer_idx)
           else mlp_param_specs(cfg.mlp_act))
    if kind in _MIXERS:
        s = {"norm": (None,), "mixer": _MIXERS[kind].specs(cfg)}
        if kind == LayerKind.MAMBA and (_layer_is_moe(cfg, layer_idx) or cfg.d_ff > 0):
            s["norm_mlp"] = (None,)
            s["mlp"] = mlp
        return s
    s = {"norm_attn": (None,), "norm_mlp": (None,), "mlp": mlp,
         "attn": (mla.mla_param_specs(cfg) if kind == LayerKind.MLA
                  else attention.attn_param_specs(cfg))}
    if cfg.post_block_norm:
        s["post_norm_attn"] = (None,)
        s["post_norm_mlp"] = (None,)
    return s


def _layer_cache_specs(cfg: ModelConfig, kind: LayerKind):
    """Logical axes for each cache/state tensor of one layer (its index: ())."""
    if kind in attention.ATTN_KINDS:
        return attention.KVCache(
            k=("batch", "seq_kv", "kv_heads", None),
            v=("batch", "seq_kv", "kv_heads", None),
            index=(),
        )
    if kind == LayerKind.MLA:
        return mla.MLACache(
            c_kv=("batch", "seq_kv", None),
            k_rope=("batch", "seq_kv", None),
            index=(),
        )
    if kind == LayerKind.MAMBA:
        return mamba.MambaState(
            conv=("batch", None, "conv_dim"),
            ssm=("batch", "conv_dim", "state"),
            index=(),
        )
    if kind == LayerKind.MLSTM:
        return xlstm.MLSTMState(
            c=("batch", None, None, None),
            n=("batch", None, None),
            m=("batch", None),
            conv=("batch", None, "conv_dim"),
            index=(),
        )
    if kind == LayerKind.SLSTM:
        return xlstm.SLSTMState(
            c=("batch", None, None),
            n=("batch", None, None),
            h=("batch", None, None),
            m=("batch", None, None),
            index=(),
        )
    raise ValueError(kind)


def cache_specs(cfg: ModelConfig) -> list:
    """Logical axes matching ``init_caches``: one per layer."""
    return [_layer_cache_specs(cfg, kind) for kind in cfg.layer_kinds]


def _place_cache(cache, specs):
    """A layer's cache with every tensor laid out on the ambient mesh by its
    spec."""
    return dataclasses.replace(cache, **{
        f.name: sharding.distribute(getattr(cache, f.name), *getattr(specs, f.name))
        for f in dataclasses.fields(cache) if f.name != "index"})


class MoeWeights(nn.Module):
    """One MoE layer's weights: the float32 router, the routed experts (E, ., .)
    in the model's dtype and the ``shared`` experts' MLP; read as a mapping
    by ``moe.moe_block``."""

    def __init__(self, d_model: int, moe, dtype: torch.dtype, device):
        super().__init__()
        for name, shape in moe_mod.moe_shapes(d_model, moe).items():
            setattr(self, name, _param(shape, torch.float32 if name == "router" else dtype,
                                       device))
        if moe.num_shared > 0:
            self.shared = _params(mlp_shapes(d_model, moe.num_shared * moe.d_expert, "silu"),
                                  dtype, device)

    def __getitem__(self, name: str):
        return getattr(self, name)


class AttnLayer(nn.Module):
    """One ``LayerKind.ATTN``, ``ATTN_LOCAL`` or ``MLA`` layer's weights
    (``kind``), with a dense MLP or, where ``_layer_is_moe`` (``is_moe``), a
    MoE."""

    def __init__(self, cfg: ModelConfig, kind: LayerKind, index: int, dtype: torch.dtype,
                 device):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.is_moe = _layer_is_moe(cfg, index)
        self.norm_attn = _param((d,), torch.float32, device)
        self.attn = _params(mla.mla_shapes(cfg) if kind == LayerKind.MLA
                            else attention.attn_shapes(cfg), dtype, device)
        self.norm_mlp = _param((d,), torch.float32, device)
        self.mlp = (MoeWeights(d, cfg.moe, dtype, device) if self.is_moe
                    else _params(mlp_shapes(d, cfg.d_ff, cfg.mlp_act), dtype, device))
        if cfg.post_block_norm:
            self.post_norm_attn = _param((d,), torch.float32, device)
            self.post_norm_mlp = _param((d,), torch.float32, device)


def _mixer_params(cfg: ModelConfig, kind: LayerKind, dtype: torch.dtype,
                  device) -> nn.ParameterDict:
    """A recurrent mixer's weights: its module's ``FLOAT32`` tensors in
    float32, the projections in the model's dtype."""
    mixer = _MIXERS[kind]
    return nn.ParameterDict({name: _param(shape, torch.float32 if name in mixer.float32
                                          else dtype, device)
                             for name, shape in mixer.shapes(cfg).items()})


class MambaLayer(nn.Module):
    """One ``LayerKind.MAMBA`` layer's weights: the mixer, then a MoE where
    ``_layer_is_moe`` (``is_moe``), else a dense MLP when ``cfg.d_ff > 0``,
    else none (the reference's ``_init_layer``)."""

    kind = LayerKind.MAMBA

    def __init__(self, cfg: ModelConfig, index: int, dtype: torch.dtype, device):
        super().__init__()
        d = cfg.d_model
        self.is_moe = _layer_is_moe(cfg, index)
        self.norm = _param((d,), torch.float32, device)
        self.mixer = _mixer_params(cfg, self.kind, dtype, device)
        if self.is_moe or cfg.d_ff > 0:
            self.norm_mlp = _param((d,), torch.float32, device)
            self.mlp = (MoeWeights(d, cfg.moe, dtype, device) if self.is_moe
                        else _params(mlp_shapes(d, cfg.d_ff, cfg.mlp_act), dtype, device))


class XlstmLayer(nn.Module):
    """One ``LayerKind.MLSTM`` or ``SLSTM`` layer's weights (``kind``): the
    RMSNorm scale and the block's, no MLP (the reference's ``_init_layer``)."""

    is_moe = False

    def __init__(self, cfg: ModelConfig, kind: LayerKind, dtype: torch.dtype, device):
        super().__init__()
        self.kind = kind
        self.norm = _param((cfg.d_model,), torch.float32, device)
        self.mixer = _mixer_params(cfg, kind, dtype, device)


def _add(x: torch.Tensor, h: torch.Tensor):
    """The residual sum ``x + h``: (the sum in x's dtype, its float32 value
    before that rounding).  The reference's jitted forward rounds the residual
    stream to the model's dtype, but the RMSNorm that reads a sum reads it
    unrounded: under excess precision XLA drops the round trip through
    bfloat16 between the add and the norm's cast to float32.  (Across the
    reference's scanned units the stream is the scan's carry, rounded:
    ``LMModel.apply``.)"""
    s = x.float() + h
    return s.to(x.dtype), s


def _mlp(layer, x: torch.Tensor, x32: torch.Tensor, cfg: ModelConfig):
    """The layer's MLP or MoE on RMSNorm(x): (out, the MoE's aux terms or None)."""
    h = common.rms_norm(x32, layer.norm_mlp, cfg.norm_eps, x.dtype)
    if layer.is_moe:
        return moe_mod.moe_block(layer.mlp, h, cfg.moe)
    return mlp_block(layer.mlp, h, cfg.mlp_act), None


def _apply_layer(layer, x: torch.Tensor, x32: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, cache, tag: Callable = lambda h: h):
    """``x``: the residual stream in the model's dtype, ``x32``: the float32
    value of its last sum (``_add``).  ``tag`` marks an attention layer's
    mixer and MLP outputs, before any post-block norm (the reference's
    ``mixer_out`` and ``mlp_out`` names).  Returns (x, x32, new_cache, the
    MoE's aux terms or None)."""
    eps = cfg.norm_eps
    mixer = layer.kind in _MIXERS
    h = common.rms_norm(x32, layer.norm if mixer else layer.norm_attn, eps, x.dtype)
    if mixer:
        h, new_cache = _MIXERS[layer.kind].block(layer.mixer, h, cfg, cache)
    elif layer.kind == LayerKind.MLA:
        h, new_cache = mla.mla_block(layer.attn, h, positions, cfg, cache)
    else:
        h, new_cache = attention.attention_block(layer.attn, h, positions, cfg, layer.kind,
                                                 cache)
    if not mixer:
        h = tag(h)
    if cfg.post_block_norm and not mixer:
        h = common.rms_norm(h, layer.post_norm_attn, eps)
    x, x32 = _add(x, h)
    if not hasattr(layer, "mlp"):                 # an xLSTM layer, a Mamba layer without d_ff
        return x, x32, new_cache, None
    h, aux = _mlp(layer, x, x32, cfg)
    if not mixer:
        h = tag(h)
    if cfg.post_block_norm and not mixer:
        h = common.rms_norm(h, layer.post_norm_mlp, eps)
    x, x32 = _add(x, h)
    return x, x32, new_cache, aux


@contextlib.contextmanager
def _fsdp_gathered(layer, specs: Optional[dict]):
    """Within: the layer's weights split over the "fsdp" axes gathered for
    use (ZeRO-3, as GSPMD gathers the reference's: DTensor, left to itself,
    may move the activations instead, and a head could compute every token
    against the whole vocabulary on every rank); their gradients go back
    to the shards.  ``specs`` are the layer's logical axes by parameter name
    (None without a mesh: nothing to do)."""
    if not specs:
        yield
        return
    swapped = []
    for name, axes in specs.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = layer.get_submodule(owner_name) if owner_name else layer
        weight = owner._parameters[leaf]
        owner._parameters[leaf] = sharding.logical_constraint(
            weight, tuple(None if a == "fsdp" else a for a in axes))
        swapped.append((owner, leaf, weight))
    try:
        yield
    finally:
        for owner, leaf, weight in swapped:
            owner._parameters[leaf] = weight


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  Under a mesh (DTensors), the vocab-parallel lookup
    GSPMD makes of the reference's: the table laid out by "vocab" only (its
    "fsdp" split gathered), each rank reads the rows it holds for its
    shard of ``ids`` (zeros for the ids outside them, whose pending sum over
    the vocab's mesh axes is the row), on local shards (DTensor's own
    strategy for the lookup's backward fails in some torch versions)."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    table = sharding.logical_constraint(table, ("vocab", None))
    split = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    index = 0
    for i in split:                          # this rank's shard of the rows, mesh-major
        index = index * mesh.size(i) + mesh.get_local_rank(i)
    out = list(sharding.logical_placements(("batch", "seq", None), mesh=mesh))
    for i in split:
        out[i] = Partial()

    def local(rows, local_ids):
        first = index * rows.shape[0]
        at = local_ids - first
        held = (at >= 0) & (at < rows.shape[0])
        got = rows[at.clamp(0, rows.shape[0] - 1)]
        return torch.where(held[..., None], got, got.new_zeros(()))

    ids = sharding.logical_constraint(ids, ("batch", "seq"))
    return local_map(local, out_placements=out,
                     in_placements=(tuple(table.placements), tuple(ids.placements)),
                     device_mesh=mesh)(table, ids)


class _Names(threading.local):
    tagging = False


_names = _Names()


def _tag_name(h: torch.Tensor) -> torch.Tensor:
    """A copy of ``h`` that the "names" remat policy saves (the reference's
    ``checkpoint_name``): the policy keeps the output of the one operation
    made while the flag is up."""
    _names.tagging = True
    try:
        return h.clone()
    finally:
        _names.tagging = False


def _save_names(ctx, op, *args, **kwargs):
    """The "names" policy: save the tagged outputs, recompute the rest (the
    reference's ``save_only_these_names("mixer_out", "mlp_out")``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if _names.tagging
            else CheckpointPolicy.PREFER_RECOMPUTE)


class _Unit(nn.Module):
    """One repeated unit's layers (the modules of the model, not copies),
    run under activation checkpointing by ``LMModel.apply``: only the
    residual stream enters; its float32 value is re-derived at the start, as
    the reference's scan carry is rounded there."""

    def __init__(self, layers, cfg: ModelConfig, tag: Callable, specs: list):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.cfg, self.tag, self.specs = cfg, tag, specs

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """(x after the unit, each layer's MoE aux terms or None)."""
        x32 = x.float()
        auxes = []
        for layer, specs in zip(self.layers, self.specs):
            with _fsdp_gathered(layer, specs):
                x, x32, _, layer_aux = _apply_layer(layer, x, x32, positions, self.cfg, None,
                                                    self.tag)
            auxes.append(layer_aux)
        return x, auxes


def _remat(unit: _Unit, x: torch.Tensor, positions: torch.Tensor, policy: str):
    """``unit(x, positions)`` under ``torch.utils.checkpoint`` (non-reentrant):
    policy "nothing" keeps only ``x`` for the backward, "names" also the
    tagged outputs.  The weights go in as the checkpoint's inputs, so that
    the recomputation runs on the tensors the forward ran on (the trainer's
    aliases, bound by ``functional_call`` only while the forward runs)."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    names = [n for n, _ in unit.named_parameters()]
    weights = [p for _, p in unit.named_parameters()]
    mesh, rules = sharding.current_mesh(), sharding.current_rules()

    def run(x, *ws):
        # The recomputation runs on autograd's thread for the device, which
        # does not see this thread's mesh and rules: they go with it.
        with sharding.use_mesh(mesh), sharding.use_rules(rules), \
                sharding.plain_as_replicated():
            return torch.func.functional_call(unit, dict(zip(names, ws)), (x, positions))

    context = {}
    if policy == "names":
        context["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                  _save_names)
    elif policy != "nothing":
        raise ValueError(f"remat_policy must be 'nothing' or 'names', got {policy!r}")
    return checkpoint(run, x, *weights, use_reentrant=False, **context)


@torch.no_grad()
def _copy_into(target, weights: dict) -> None:
    for name, w in weights.items():
        if isinstance(w, dict):
            _copy_into(target[name], w)
        else:
            target[name].copy_(w)


class LMModel(nn.Module):
    """The decoder on ``device`` (``None``: ``cuda:0``, raising without a
    card; ``"meta"`` builds the shapes only).  The weights are allocated
    uninitialised: call :meth:`init` or ``load_state_dict``.

    :meth:`apply` keeps the reference's name and so replaces
    ``nn.Module.apply(fn)``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        d, vocab = cfg.d_model, cfg.vocab_size
        self.embed = _param((vocab, d), self.dtype, self.device)
        self.final_norm = _param((d,), torch.float32, self.device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((d, vocab), self.dtype, self.device)
        self.layers = nn.ModuleList(
            MambaLayer(cfg, i, self.dtype, self.device) if kind == LayerKind.MAMBA
            else XlstmLayer(cfg, kind, self.dtype, self.device) if kind in _MIXERS
            else AttnLayer(cfg, kind, i, self.dtype, self.device)
            for i, kind in enumerate(cfg.layer_kinds))

    # ---------------- init ------------------------------------------------
    @torch.no_grad()
    @sharding.plain_as_replicated()
    def init(self, seed: int) -> "LMModel":
        """Seeded weights with the reference's distributions (unit-normal
        embedding, fan-in truncated normals, zero norm scales and biases; the
        recurrent mixers' as ``mamba.init_mamba_params``,
        ``xlstm.init_mlstm_params`` and ``init_slstm_params``), drawn on the model's
        device from a ``torch.Generator``: other numbers than ``jax.random``
        gives for the same seed.  A MoE's routed tensors are drawn in float32
        one at a time, each copied into its parameter before the next, so
        that ``init`` needs the weights plus one such tensor.  Under a mesh
        each draw is copied into its DTensor's local shards."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embed.copy_(common.embed_init(gen, tuple(self.embed.shape), device=dev))
        self.final_norm.zero_()
        if not cfg.tie_embeddings:
            self.lm_head.copy_(common.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                                 device=dev))
        for layer in self.layers:
            if layer.kind in _MIXERS:
                _copy_into(layer.mixer, _MIXERS[layer.kind].init(gen, cfg, dev))
            else:
                _copy_into(layer.attn, (mla.init_mla_params if layer.kind == LayerKind.MLA
                                        else attention.init_attn_params)(gen, cfg, dev))
            if layer.is_moe:
                for name, w in moe_mod.draw_moe_params(gen, cfg.d_model, cfg.moe, dev):
                    _copy_into(layer.mlp, {name: w})
                    del w
            elif hasattr(layer, "mlp"):
                _copy_into(layer.mlp, init_mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                                      dev))
            for name, p in layer.named_parameters(recurse=False):
                p.zero_()                              # the RMSNorm scales
        return self

    # ---------------- forward ----------------------------------------------
    def _embed(self, inputs: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The inputs' embeddings in the model's dtype; with sinusoidal
        positions (from 0 when none are given) added."""
        cfg = self.cfg
        if inputs.dim() == 3:              # a stub frontend's embeddings
            x = inputs.to(self.dtype)
        else:
            x = _lookup(self.embed, inputs.long())
            if cfg.post_block_norm:        # gemma2 scales the embedding, in the model's dtype
                x = x * torch.tensor(cfg.d_model ** 0.5, dtype=self.dtype)
        if cfg.pos_embedding == "sinusoidal":
            if positions is None:
                positions = torch.arange(inputs.shape[1], device=x.device).expand(inputs.shape[:2])
            pos = positions if positions.dim() == 2 else positions[..., 0]
            x = x + common.sinusoidal_embedding(pos, cfg.d_model).to(self.dtype)
        return common.with_logical(x, "batch", "seq", None)

    def _logits(self, x32: torch.Tensor) -> torch.Tensor:
        """The logits from the float32 value of the residual stream after
        the last layer (the reference's scan carries it rounded to the
        model's dtype: ``apply``)."""
        cfg = self.cfg
        x = common.rms_norm(x32, self.final_norm, cfg.norm_eps, self.dtype)
        head = (sharding.logical_constraint(self.embed, ("vocab", None)).T
                if cfg.tie_embeddings
                else sharding.logical_constraint(self.lm_head, (None, "vocab")))
        logits = common.softcap((x @ head).float(), cfg.logit_softcap)
        return common.with_logical(logits, "batch", "seq", "vocab")

    @sharding.plain_as_replicated()
    def apply(
        self,
        inputs,                                        # (B, S) token ids or (B, S, D)
        positions: Optional[torch.Tensor] = None,      # (B, S), or (B, S, 3) for M-RoPE
        caches: Optional[Caches] = None,
    ) -> tuple[torch.Tensor, Optional[Caches], dict]:
        """Returns (logits (B, S, V) float32, new_caches, aux).  ``inputs``
        are token ids, or a stub frontend's embeddings (B, S, d_model).
        Without ``positions``, position i of the inputs is the caches' index
        plus i (on all three M-RoPE streams).  ``aux`` holds the reference's
        MoE terms (``aux_loss``, ``z_loss``, ``fraction_dropped``), each
        summed over the MoE layers: float32 scalars, or 0.0 without a MoE
        layer.  Under a mesh (``distributed.sharding``) the inputs are laid
        out by "batch" and the logits are a DTensor."""
        cfg = self.cfg
        inputs = torch.as_tensor(inputs, device=self.device)
        inputs = sharding.distribute(inputs, "batch", "seq", *(None,) * (inputs.dim() - 2))
        b, s = inputs.shape[:2]
        if positions is None:
            start = 0 if caches is None else caches[0].index
            positions = (start + torch.arange(s, device=self.device)).expand(b, s)
            if cfg.pos_embedding == "mrope":
                positions = positions[..., None].expand(b, s, 3)
        else:
            positions = torch.as_tensor(positions, device=self.device)
        x = self._embed(inputs, positions)
        x32 = x.float()
        new_caches = None if caches is None else []
        aux = {"aux_loss": 0.0, "z_loss": 0.0, "fraction_dropped": 0.0}
        specs = self._layer_specs() if sharding.on_mesh() else [None] * len(self.layers)
        if cfg.remat and caches is None and torch.is_grad_enabled():
            # Training: each repeated unit under activation checkpointing (the
            # reference's jax.checkpoint of its scanned unit); the prefix
            # layers are not rematerialised, as the reference's are not.
            tag = _tag_name if cfg.remat_policy == "names" else (lambda h: h)
            n = len(cfg.prefix)
            for layer, layer_specs in zip(self.layers[:n], specs):
                with _fsdp_gathered(layer, layer_specs):
                    x, x32, _, layer_aux = _apply_layer(layer, x, x32, positions, cfg, None)
                if layer_aux is not None:
                    aux = {k: aux[k] + layer_aux[k] for k in aux}
            width = len(cfg.pattern_unit)
            for lo in range(n, len(self.layers), width):
                unit = _Unit(self.layers[lo:lo + width], cfg, tag, specs[lo:lo + width])
                x, auxes = _remat(unit, x, positions, cfg.remat_policy)
                for layer_aux in auxes:           # summed in layer order, as below
                    if layer_aux is not None:
                        aux = {k: aux[k] + layer_aux[k] for k in aux}
            return self._logits(x.float()), None, aux
        for i, layer in enumerate(self.layers):
            if _starts_unit(cfg, i):
                # The reference scans over its units: the residual stream
                # crosses from one to the next (and out to the final norm)
                # as the scan's carry, rounded to the model's dtype.
                x32 = x.float()
            with _fsdp_gathered(layer, specs[i]):
                x, x32, cache, layer_aux = _apply_layer(layer, x, x32, positions, cfg,
                                                        None if caches is None else caches[i])
            if caches is not None:
                new_caches.append(cache)
            if layer_aux is not None:
                aux = {k: aux[k] + layer_aux[k] for k in aux}
        return self._logits(x.float()), new_caches, aux

    def forward(self, inputs, positions: Optional[torch.Tensor] = None,
                caches: Optional[Caches] = None):
        """:meth:`apply` (``torch.func.functional_call`` calls the module)."""
        return self.apply(inputs, positions, caches)

    # ---------------- loss --------------------------------------------------
    @sharding.plain_as_replicated()
    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """batch: {"inputs": (B, S) or (B, S, D), "targets": (B, S) int,
        optional "mask": (B, S), optional "positions"}; ``params``: named
        tensors (``named_parameters`` names) used in place of the module's.
        Returns (scalar loss, metrics):
        the masked mean NLL of ``log_softmax``, plus the logit z-loss ``1e-4
        * mean(logsumexp^2)``, plus the MoE's ``aux_loss`` and ``z_loss``;
        metrics ``loss``, ``ce``, ``moe_aux``, ``moe_dropped`` (float32
        0-dim tensors; DTensors under a mesh)."""
        logits, _, aux = torch.func.functional_call(
            self, params, (batch["inputs"], batch.get("positions")))
        targets = torch.as_tensor(batch["targets"], device=logits.device).long()
        mask = batch.get("mask")
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        if mask is not None:
            mask = torch.as_tensor(mask, device=logits.device)
            nll = nll * mask
            denom = torch.clamp(torch.sum(mask), min=1.0)
        else:
            denom = float(nll.numel())
        ce = torch.sum(nll) / denom
        # logit z-loss for stability at scale
        z = torch.logsumexp(logits, dim=-1)
        z_loss = 1e-4 * torch.mean(torch.square(z))
        f32 = dict(dtype=torch.float32, device=logits.device)
        moe_aux, moe_z, dropped = (torch.as_tensor(aux[k], **f32)
                                   for k in ("aux_loss", "z_loss", "fraction_dropped"))
        # Under a mesh the terms may be pending sums and pending means, which
        # DTensor does not add: each is reduced first (no-ops without a mesh).
        ce, z_loss, moe_aux, moe_z = (sharding.replicated(t) for t in (ce, z_loss, moe_aux, moe_z))
        total = ce + z_loss + moe_aux + moe_z
        metrics = {"loss": total, "ce": ce, "moe_aux": moe_aux, "moe_dropped": dropped}
        return total, metrics

    # ---------------- caches -------------------------------------------------
    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16) -> Caches:
        """A cache per layer: ``dtype`` (bfloat16 by default, as the
        reference's) for the attention layers' keys and values; a float32
        state (``MambaState``, ``MLSTMState``, ``SLSTMState``) for a
        recurrent layer, whatever ``dtype``.  Under a mesh each tensor is
        laid out by ``cache_specs``."""
        cfg, dev = self.cfg, self.device
        caches = [_MIXERS[layer.kind].state(cfg, batch, dev) if layer.kind in _MIXERS
                  else (mla.init_mla_cache if layer.kind == LayerKind.MLA
                        else attention.init_kv_cache)(cfg, batch, max_len, dtype, dev)
                  for layer in self.layers]
        if sharding.on_mesh():
            caches = [_place_cache(c, specs) for c, specs in zip(caches, cache_specs(cfg))]
        return caches

    # ---------------- sharding specs ---------------------------------------
    def param_specs(self) -> dict:
        """Logical axes of every parameter, keyed by ``state_dict`` name."""
        cfg = self.cfg
        specs: dict = {"embed": ("vocab", "fsdp"), "final_norm": (None,)}
        if not cfg.tie_embeddings:
            specs["lm_head"] = ("fsdp", "vocab")
        for i, kind in enumerate(cfg.layer_kinds):
            _flatten(_layer_specs(cfg, kind, i), f"layers.{i}.", specs)
        return specs

    def _layer_specs(self) -> list[dict]:
        """Each layer's parameters' logical axes, named within the layer."""
        return [_flatten(_layer_specs(self.cfg, kind, i), "", {})
                for i, kind in enumerate(self.cfg.layer_kinds)]

    def abstract_params(self) -> dict:
        """Every parameter's shape and dtype, allocating nothing: the state
        dict of a ``meta``-device copy of the model."""
        return dict(LMModel(self.cfg, device="meta").state_dict())


@torch.no_grad()
def shard_model(model: LMModel, mesh, rules: sharding.ShardingRules) -> LMModel:
    """Each parameter of ``model`` swapped for a DTensor laid out on ``mesh``
    by its logical spec under ``rules`` (the reference's ``in_shardings`` of
    the parameters).  Returns the model."""
    for name, axes in model.param_specs().items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        placements = sharding.spec_to_placements(sharding.logical_to_spec(axes, rules, mesh),
                                                 mesh)
        weight = distribute_tensor(getattr(owner, leaf).detach(), mesh, placements)
        owner.register_parameter(leaf, nn.Parameter(weight, requires_grad=False))
    return model


# --------------------------------------------------------------------------
# the reference's weights, and parameter counting
# --------------------------------------------------------------------------
def _flatten(node: Any, prefix: str, out: dict) -> dict:
    if isinstance(node, dict):
        for key, child in node.items():
            _flatten(child, f"{prefix}{key}.", out)
    else:
        out[prefix[:-1]] = node
    return out


def _unit_slice(node: Any, u: int) -> Any:
    if isinstance(node, dict):
        return {key: _unit_slice(child, u) for key, child in node.items()}
    return node[u]


def params_from_reference(cfg: ModelConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The reference's parameter pytree (``jax.tree.map(np.asarray,
    model.init(key))``) as the port's float32 state dict, for
    ``load_state_dict`` (which casts to the model's dtype): ``units`` unstacked
    into one entry per layer, the projections reshaped to the port's
    matrices (the recurrent mixers' tensors have the reference's shapes)."""
    shapes = {k: v.shape for k, v in LMModel(cfg, device="meta").state_dict().items()}
    flat = _flatten({k: v for k, v in tree.items() if k not in ("prefix", "units")}, "", {})
    layers = list(tree["prefix"]) + [_unit_slice(unit, u) for u in range(cfg.num_units)
                                     for unit in tree["units"]]
    for i, layer in enumerate(layers):
        _flatten(layer, f"layers.{i}.", flat)
    if flat.keys() != shapes.keys():
        raise ValueError(f"reference tree does not fit {cfg.name}: extra "
                         f"{sorted(flat.keys() - shapes.keys())}, missing "
                         f"{sorted(shapes.keys() - flat.keys())}")
    return {k: torch.from_numpy(np.array(flat[k], np.float32)).reshape(shape)
            for k, shape in shapes.items()}


def opt_state_from_reference(cfg: ModelConfig, state: dict) -> dict:
    """The reference's AdamW state (``jax.tree.map(np.asarray,
    adamw_init(...))`` or a later one: ``m`` and ``v`` pytrees shaped as the
    parameters, a scalar ``step``) as the port's (``optim/adamw.py``): ``m``
    and ``v`` named as ``named_parameters`` in the port's layout, in their
    own dtype, and ``step`` an int32 0-dim tensor."""
    def moments(tree):
        leaves = []
        _map_leaves(tree, leaves.append)
        dtype = getattr(torch, str(np.asarray(leaves[0]).dtype))
        out = params_from_reference(cfg, _map_leaves(tree, lambda a: np.asarray(a, np.float32)))
        return {k: v.to(dtype) for k, v in out.items()}

    return {"m": moments(state["m"]), "v": moments(state["v"]),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32)}


def _map_leaves(node: Any, fn: Callable) -> Any:
    if isinstance(node, dict):
        return {k: _map_leaves(v, fn) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_leaves(v, fn) for v in node]
    return fn(node)


@functools.lru_cache(maxsize=None)
def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total parameters, as the reference counts them.  ``active_only``
    counts each routed expert tensor of an MoE layer past ``cfg.prefix`` at
    ``top_k / num_experts`` of its size: the reference's rule, which scales
    the leaves of its stacked ``units`` whose second axis is the expert
    count (the prefix's layers are not stacked).  Memoised (a config is
    frozen)."""
    model = LMModel(cfg, device="meta")
    total = sum(p.numel() for p in model.parameters())
    if not active_only or cfg.moe is None:
        return total
    routed = sum(layer.mlp[name].numel()
                 for i, layer in enumerate(model.layers)
                 if layer.is_moe and i >= len(cfg.prefix) for name in moe_mod.ROUTED)
    return total - routed + routed * cfg.moe.top_k // cfg.moe.num_experts
