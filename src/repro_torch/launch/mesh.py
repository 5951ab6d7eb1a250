"""Production meshes and per-(arch, shape) sharding-rule resolution
(counterpart of ``repro/launch/mesh.py``).

Importing this module touches no process group; meshes are built by
functions only, over whatever ``torch.distributed`` process group the caller
initialised (the reference's ``jax.make_mesh`` over the devices JAX sees).
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models.config import ModelConfig


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh of ``shape`` named ``axis_names`` over the initialised
    process group (whose world size must be the shape's product), on
    ``device_type`` ("cuda": the card of each rank; "cpu" for a gloo or
    fake group).  Raises when no process group is initialised."""
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group is initialised: call "
                           "init_process_group (world size "
                           f"{'x'.join(map(str, shape))}) before building a mesh")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """Single pod: (16, 16) = (data, model) -- 256 devices.
    Multi-pod: (2, 16, 16) = (pod, data, model) -- 512 devices; the pod axis
    composes with data for DP/FSDP and carries the slow inter-pod links."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def _axis_size(mesh: DeviceMesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(name, 1)


def _decode_cache_bytes(cfg: ModelConfig, batch: int, shape_name: str) -> float:
    from repro_torch.analysis.roofline import _cache_bytes
    from repro_torch.configs.shapes import SHAPES

    return _cache_bytes(cfg, batch, SHAPES[shape_name].seq_len)


# Per-device byte budgets for the OPTIMIZED serving layout: below these,
# weights/caches replicate across the data axis instead of FSDP-sharding --
# serving replicas should not all-gather weights per token.
SERVE_WEIGHT_BUDGET = 8e9
SERVE_CACHE_BUDGET = 2e9


def make_rules(
    cfg: ModelConfig,
    mesh: DeviceMesh,
    global_batch: Optional[int] = None,
    shape_name: str = "train_4k",
    optimized: bool = False,
) -> ShardingRules:
    """Resolve logical->physical rules for one (arch, mesh, shape) cell.

    Divisibility-driven fallbacks (a size that does not divide replicates;
    DTensor would split it unevenly instead):
      * heads/kv_heads shard over `model` only when divisible (qwen2-vl's
        28 heads and every kv<16 config replicate instead; expanded-KV
        attention keeps TP on the q/o projections regardless).
      * batch shards over (pod, data) when divisible, else data, else
        replicates (long_500k's batch=1).
      * long-context decode (batch too small to fill the mesh) shards the
        KV-cache SEQUENCE axis over whatever batch left free -- sequence
        parallelism for the 500k cache.
    """
    model_sz = _axis_size(mesh, "model")
    data_sz = _axis_size(mesh, "data")
    pod_sz = _axis_size(mesh, "pod")

    heads = "model" if cfg.num_heads % model_sz == 0 else None
    kv_heads = "model" if cfg.num_kv_heads % model_sz == 0 else None

    batch: tuple[str, ...] | None
    if global_batch is None:
        global_batch = 0
    if pod_sz > 1 and global_batch % (pod_sz * data_sz) == 0:
        batch = ("pod", "data")
        batch_used = pod_sz * data_sz
    elif global_batch % data_sz == 0:
        batch = ("data",)
        batch_used = data_sz
    else:
        batch = None
        batch_used = 1

    # SP for the KV cache when batch under-fills the mesh (long_500k).
    seq_kv: tuple[str, ...] | None = None
    if batch is None:
        seq_kv = tuple(
            a for a in ("pod", "data", "model") if _axis_size(mesh, a) > 1
        ) or None
    elif kv_heads is None:
        seq_kv = ("model",)

    fsdp: tuple[str, ...] | None = ("pod", "data") if pod_sz > 1 else ("data",)

    mode = "train" if shape_name.startswith("train") else "serve"
    if optimized and mode == "serve":
        # The serving weight layout: inference replicas OWN their weights
        # rather than all-gather FSDP shards every step.  Weights stay
        # TP-sharded over `model` and replicate over data/pod when the
        # per-device copy fits; likewise the KV cache replicates over
        # `model` (it is already batch-sharded) when small enough, avoiding
        # the in-place update of a sharded axis.
        from repro_torch.models.model import count_params  # late: avoids cycle

        weight_bytes = count_params(cfg) * 2 / model_sz
        if weight_bytes <= SERVE_WEIGHT_BUDGET:
            fsdp = None
        if batch is not None and kv_heads is None and seq_kv == ("model",):
            cache_local = _decode_cache_bytes(cfg, global_batch, shape_name)
            cache_local /= batch_used
            if cache_local <= SERVE_CACHE_BUDGET:
                seq_kv = None

    experts = "model" if (cfg.moe and cfg.moe.num_experts % model_sz == 0) else None

    # mamba/xlstm inner dim over model when divisible
    conv_ok = True
    if cfg.mamba is not None:
        conv_ok = (cfg.mamba.expand * cfg.d_model) % model_sz == 0
    conv_dim = "model" if conv_ok else None

    return ShardingRules(
        batch=batch,
        seq=None,
        seq_kv=seq_kv,
        heads=heads,
        kv_heads=kv_heads,
        ffn="model" if (cfg.d_ff == 0 or cfg.d_ff % model_sz == 0) else None,
        vocab="model" if cfg.vocab_size % model_sz == 0 else None,
        experts=experts,
        conv_dim=conv_dim,
        state=None,
        fsdp=fsdp,
        layers=None,
    )
