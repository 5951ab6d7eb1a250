"""Multi-pod dry run: trace one step of every (arch x shape x mesh) cell
(counterpart of ``repro/launch/dryrun.py``).

For each cell this script

  1. initialises a ``fake`` process group of 256 or 512 ranks (rank 0 of a
     world whose collectives move nothing) and builds the production mesh,
     (16, 16) single pod or (2, 16, 16) multi-pod, on ``--device-type``;
  2. resolves the arch's sharding rules (``launch/mesh.py::make_rules``);
  3. under ``FakeTensorMode`` (no allocation anywhere) builds the model as
     DTensors laid out by its specs, the AdamW state (train) or the caches
     (serve), and the inputs of ``configs/shapes.py``, laid out by "batch";
  4. runs the train step (``make_train_step(presplit=True)``, the reference's
     microbatch count) or the serve step (``apply`` with caches, the last
     position's logits) once under three meters: per-device flops
     (``meters.DeviceFlopCounter``), collective result bytes by kind
     (``meters.CollectiveCounter``) and memory (``meters.StepMemTracker``).

Records go to ``results/dryrun_torch[_opt]/<mesh>/<arch>__<shape>.json``, one
file per cell, so the sweep is restartable.  Every record keeps the
reference's keys where they have a counterpart; the differences:

- ``flops`` is ONE device's count of the step's local operations
  (``flops_scope: "per_device"``), as the reference's ``cost_analysis`` of
  the partitioned program, but with every loop's trip count (the port runs
  Python loops: microbatches, layers, attention tiles); the flash ops count
  by their registered formulas (visible query-key pairs).
- ``collectives`` are whole-step totals for one device, by the reference's
  five kinds (plus ``other``: broadcasts and scatters) and ``count``.
- ``memory`` comes from MemTracker, per device: ``argument_bytes`` is what
  is live when the step starts (parameters, optimizer state, inputs and
  caches: the reference's arguments), ``peak_bytes`` the peak of
  MemTracker's total, ``temp_bytes`` their difference, and
  ``output_bytes`` the step's results that do not alias an argument (the
  port updates parameters, moments and caches in place).  ``breakdown``
  holds MemTracker's categories at the peak (it files ``autograd.grad``'s
  gradients, made in the backward, under ``temps``, and the float32
  accumulator under ``activations``).
- ``trace_s`` replaces ``lower_s`` and ``compile_s``; ``hlo_bytes`` has no
  counterpart (no compiled program to ask) and is ``null``.

Decode cells attend over a full cache: its index is ``seq_len - 1``, so the
new token is the last of the 32,768 (or 524,288) positions, where the
reference compiles its decode for any index.

``--optimized`` applies the reference's four serving and training changes:
``remat_policy="names"``; ``causal_skip`` (the flash kernels already never
visit a fully masked tile, so this changes nothing in the port);
``cache_update="onehot"`` on a decode cell whose cache sequence is sharded
(``models/attention.py::cache_insert``); and bf16 serving weights, which the
port already holds (its matrices are in the model's dtype; the float32
norm scales, router and recurrent gates stay float32).

Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-done] \
      [--jobs 8] [--cell-timeout 1200]

``--device-type`` is ``cuda`` by default (what the card runs: fake CUDA
tensors, nothing allocated on the card) and raises without CUDA;
``--device-type cpu`` traces on the host, where DTensor's collectives differ
(an all-to-all becomes an all-gather and a chunk).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import multiprocessing
import os
import signal
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, shape_applicable
from repro_torch.distributed import sharding
from repro_torch.kernels import flash_attention  # noqa: F401 (registers the flash ops)
from repro_torch.launch import meters
from repro_torch.launch.mesh import make_mesh, make_rules
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LMModel, count_params, shard_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime.train_loop import make_train_step

RESULTS_DIR = str(Path(__file__).resolve().parents[3] / "results" / "dryrun_torch")

#: The production meshes: (shape, axis names) and the record's label.
PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def mesh_label(mesh_shape: tuple) -> str:
    return "x".join(str(n) for n in mesh_shape)


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------
def _batch_specs(cfg: ModelConfig, mode: str) -> dict:
    """Logical axes for the (pre-split) train batch / serve inputs."""
    emb = cfg.frontend in ("vision_stub", "audio_stub")
    mrope = cfg.pos_embedding == "mrope"
    if mode == "train":
        tok = (None, "batch", "seq", None) if emb else (None, "batch", "seq")
        pos = (None, "batch", "seq", None) if mrope else (None, "batch", "seq")
        return {"inputs": tok, "targets": (None, "batch", "seq"), "positions": pos}
    tok = ("batch", "seq", None) if emb else ("batch", "seq")
    pos = ("batch", "seq", None) if mrope else ("batch", "seq")
    return {"inputs": tok, "positions": pos}


def _presplit_train_specs(cfg: ModelConfig, spec: ShapeSpec, microbatches: int) -> dict:
    """(shape, dtype) of each pre-split train batch tensor: a leading
    (microbatches, mb) pair in place of the global batch."""
    b, s = spec.global_batch, spec.seq_len
    mb = b // microbatches
    emb = cfg.frontend in ("vision_stub", "audio_stub")
    mrope = cfg.pos_embedding == "mrope"
    return {
        "inputs": ((microbatches, mb, s, cfg.d_model), torch.bfloat16) if emb
        else ((microbatches, mb, s), torch.int32),
        "targets": ((microbatches, mb, s), torch.int32),
        "positions": ((microbatches, mb, s, 3), torch.int32) if mrope
        else ((microbatches, mb, s), torch.int32),
    }


def _serve_specs(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    """(shape, dtype) of the serve step's inputs: the whole prompt
    (prefill) or one token (decode)."""
    b = spec.global_batch
    s = 1 if spec.mode == "decode" else spec.seq_len
    emb = cfg.frontend in ("vision_stub", "audio_stub")
    mrope = cfg.pos_embedding == "mrope"
    return {
        "inputs": ((b, s, cfg.d_model), torch.bfloat16) if emb else ((b, s), torch.int32),
        "positions": ((b, s, 3), torch.int32) if mrope else ((b, s), torch.int32),
    }


def _laid_out(shapes: dict, axes: dict, device) -> dict:
    """Fake tensors of ``shapes`` laid out on the ambient mesh by ``axes``."""
    return {k: sharding.distribute(torch.zeros(shape, dtype=dtype, device=device), *axes[k])
            for k, (shape, dtype) in shapes.items()}


def _local_bytes(tensors) -> int:
    total = 0
    for t in tensors:
        if isinstance(t, DTensor):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def _storages(tensors) -> set:
    out = set()
    for t in tensors:
        if isinstance(t, DTensor):
            t = t.to_local()
        out.add(t.untyped_storage()._cdata)
    return out


def _leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x) for t in _leaves(getattr(x, f.name))]
    return []


def _batch_shards(rules, mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    axes = rules.batch or ()
    axes = (axes,) if isinstance(axes, str) else axes
    return math.prod(sizes.get(a, 1) for a in axes)


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    verbose: bool = True,
    optimized: bool = False,
    *,
    device_type: str = "cuda",
    mesh_shape: Optional[tuple] = None,
    mesh_axes: Optional[tuple] = None,
    cfg: Optional[ModelConfig] = None,
    spec: Optional[ShapeSpec] = None,
) -> dict:
    """Trace one cell's step; returns its record.

    ``mesh_shape`` / ``mesh_axes`` default to the production mesh
    (``multi_pod`` picks which); ``cfg`` to ``get_config(arch)`` and ``spec``
    to ``SHAPES[shape_name]`` (tests pass a reduced config, a small mesh and
    cut sizes).  A ``fake`` process group of the mesh's size is initialised
    here and destroyed before returning; none may be initialised already.
    """
    cfg = cfg or get_config(arch)
    if optimized:
        cfg = dataclasses.replace(cfg, causal_skip=True, remat_policy="names")
    spec = spec or SHAPES[shape_name]
    if mesh_shape is None:
        mesh_shape, mesh_axes = PRODUCTION_MESHES[multi_pod]
    mesh_shape, mesh_axes = tuple(mesh_shape), tuple(mesh_axes)
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' needs CUDA (pass device_type='cpu' to trace "
                           "on the host, where DTensor's collectives differ)")
    if dist.is_initialized():
        raise RuntimeError("run_cell initialises its own fake process group: destroy the "
                           "current one first")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n_dev = math.prod(mesh_shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_dev)
    try:
        mesh = make_mesh(mesh_shape, mesh_axes, device_type)
        rules = make_rules(cfg, mesh, global_batch=spec.global_batch, shape_name=shape_name,
                           optimized=optimized)
        if optimized and spec.mode == "decode" and rules.seq_kv is not None:
            cfg = dataclasses.replace(cfg, cache_update="onehot")
        record = _trace(arch, shape_name, cfg, spec, mesh, rules, device_type)
    finally:
        dist.destroy_process_group()
    record.update(optimized=optimized, mesh=mesh_label(mesh_shape), devices=n_dev)
    if verbose:
        print(json.dumps(record, default=str), flush=True)
    return record


def _trace(arch, shape_name, cfg, spec, mesh, rules, device_type) -> dict:
    device = torch.device(device_type)
    params_total = count_params(cfg)
    t0 = time.perf_counter()
    with _strided_shard_sizes_on_host(), meters.propagation_marked(), \
            FakeTensorMode(allow_non_fake_inputs=True), sharding.use_mesh(mesh), \
            sharding.use_rules(rules):
        model = shard_model(LMModel(cfg, device=device), mesh, rules)
        params = dict(model.named_parameters())
        extra = {}
        if spec.mode == "train":
            microbatches = max(1, spec.global_batch // max(_batch_shards(rules, mesh), 1))
            moment = "bfloat16" if params_total > 1e11 else "float32"
            opt_cfg = AdamWConfig(m_dtype=moment, v_dtype=moment)
            opt_state = adamw_init(params, opt_cfg)
            batch = _laid_out(_presplit_train_specs(cfg, spec, microbatches),
                              _batch_specs(cfg, "train"), device)
            step = make_train_step(model, opt_cfg, ScheduleConfig(), microbatches=microbatches,
                                   presplit=True)
            state = list(opt_state["m"].values()) + list(opt_state["v"].values())
            inputs = list(batch.values())
            extra["microbatches"] = microbatches

            def run():
                return step(params, opt_state, batch)[2]
        else:
            caches = model.init_caches(spec.global_batch, spec.seq_len)
            if spec.mode == "decode":
                caches = [dataclasses.replace(c, index=spec.seq_len - 1) for c in caches]
            ins = _laid_out(_serve_specs(cfg, spec), _batch_specs(cfg, "serve"), device)
            state = []
            inputs = list(ins.values()) + _leaves(caches)

            def run():
                with torch.no_grad():
                    logits, new_caches, _ = model.apply(ins["inputs"], ins["positions"],
                                                        caches=caches)
                    return logits[:, -1:], new_caches

        tracker = meters.StepMemTracker()
        tracker.track_external(model, *state, *inputs)
        with tracker, meters.CollectiveCounter() as coll, meters.DeviceFlopCounter() as flops:
            at_entry = _total(tracker.get_tracker_snapshot("current"))
            out = run()
        peak_snap = tracker.get_tracker_snapshot("peak")
        known = _storages(list(params.values()) + state + inputs)
        output = _local_bytes(t for t in _leaves(out) if _storages([t]).isdisjoint(known))
    trace_s = time.perf_counter() - t0

    peak = _total(peak_snap)
    cats = next(iter(peak_snap.values()), {})
    return {
        "arch": arch,
        "shape": shape_name,
        "mode": spec.mode,
        "device_type": device_type,
        "params": params_total,
        "active_params": count_params(cfg, active_only=True),
        "trace_s": round(trace_s, 1),
        "flops": float(flops.get_total_flops()),
        "flops_scope": "per_device",
        "flash_flops": float(sum(v for k, v in flops.get_flop_counts().get("Global", {}).items()
                                 if k in _FLASH_OPS)),
        "flash_calls": {name: flops.calls[op] for name, op in
                        (("forward", torch.ops.repro_torch.flash_fwd),
                         ("backward", torch.ops.repro_torch.flash_bwd))},
        "hlo_bytes": None,
        "memory": {
            "argument_bytes": at_entry,
            "output_bytes": output,
            "temp_bytes": peak - at_entry,
            "peak_bytes": peak,
            "breakdown": {
                "parameters": cats.get("Parameter", 0) + cats.get("Buffer", 0),
                "optimizer": _local_bytes(state) + cats.get("Optstate", 0),
                "inputs": _local_bytes(inputs),
                "gradients": cats.get("Gradient", 0),
                "activations": cats.get("Activation", 0),
                "temps": cats.get("Temp", 0),
            },
        },
        "collectives": coll.totals,
        "rules": {
            "batch": rules.batch, "heads": rules.heads, "kv_heads": rules.kv_heads,
            "seq_kv": rules.seq_kv, "fsdp": rules.fsdp, "experts": rules.experts,
        },
        **extra,
    }


@contextlib.contextmanager
def _strided_shard_sizes_on_host():
    """DTensor works out a ``_StridedShard``'s local indices with
    ``torch.arange`` and ``tolist`` (a reshape of a dimension split on two
    mesh axes makes one, in the backward's matmuls).  Under
    ``FakeTensorMode`` that arange is fake and ``tolist`` raises; this runs
    that index arithmetic on real (small, host) tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    original = _StridedShard.local_shard_size_and_offset

    @functools.wraps(original)
    def on_host(*args, **kwargs):
        with unset_fake_temporarily():
            return original(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = original


_FLASH_OPS = (torch.ops.repro_torch.flash_fwd, torch.ops.repro_torch.flash_bwd)


def _total(snapshot: dict) -> int:
    return sum(dev.get("Total", 0) for dev in snapshot.values())


def _result_path(arch: str, shape_name: str, multi_pod: bool, optimized: bool = False) -> str:
    base = RESULTS_DIR + "_opt" if optimized else RESULTS_DIR
    d = os.path.join(base, mesh_label(PRODUCTION_MESHES[multi_pod][0]))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape_name}.json")


class CellTimeout(Exception):
    """A cell's trace ran past ``--cell-timeout``."""


def _run_and_save(arch: str, shape_name: str, multi_pod: bool, optimized: bool,
                  device_type: str, timeout_s: int) -> tuple:
    """One cell in a worker process: (arch, shape, error or None, trace s).
    The record goes to its file; a trace past ``timeout_s`` is stopped by a
    SIGALRM and reported as the cell's failure."""
    def expire(signum, frame):
        raise CellTimeout(f"trace exceeded the {timeout_s} s cell limit")

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if timeout_s > 0:
        signal.signal(signal.SIGALRM, expire)
        signal.alarm(timeout_s)
    try:
        record = run_cell(arch, shape_name, multi_pod=multi_pod, optimized=optimized,
                          device_type=device_type)
        with open(_result_path(arch, shape_name, multi_pod, optimized), "w") as f:
            json.dump(record, f, indent=2, default=str)
        return arch, shape_name, None, time.perf_counter() - t0
    except Exception as e:
        traceback.print_exc()
        return arch, shape_name, repr(e)[:2000], time.perf_counter() - t0
    finally:
        signal.alarm(0)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the reference's optimisations (results go to "
                         "results/dryrun_torch_opt)")
    ap.add_argument("--device-type", default="cuda", choices=("cuda", "cpu"),
                    help="the fake mesh's device type (default cuda: raises without CUDA)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own on one thread")
    ap.add_argument("--cell-timeout", type=int, default=0,
                    help="seconds a cell's trace may take before it counts as failed "
                         "(0: no limit)")
    args = ap.parse_args(argv)
    if args.device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device-type cuda (the default) needs CUDA; pass "
                           "--device-type cpu to trace on the host")

    if args.all:
        cells = [(arch, shape) for arch in ARCH_IDS for shape in SHAPES
                 if shape_applicable(get_config(arch), shape)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    mesh = mesh_label(PRODUCTION_MESHES[args.multi_pod][0])
    todo = [c for c in cells if not (args.skip_done and os.path.exists(
        _result_path(*c, args.multi_pod, args.optimized)))]
    print(f"{len(todo)} of {len(cells)} cells to trace on {mesh}"
          f"{' [optimized]' if args.optimized else ''}", flush=True)

    def report(result):
        arch, shape_name, error, seconds = result
        print(f"=== {arch} x {shape_name} x {mesh}: "
              f"{'FAILED ' + error if error else 'ok'} ({seconds:.1f} s)", flush=True)
        return result

    common = (args.multi_pod, args.optimized, args.device_type, args.cell_timeout)
    if args.jobs <= 1:
        results = [report(_run_and_save(*c, *common)) for c in todo]
    else:
        # A fresh process per cell: each initialises and destroys its own fake
        # process group.  Training cells take longest, so they start first.
        todo.sort(key=lambda c: SHAPES[c[1]].mode != "train")
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(args.jobs, mp_context=ctx,
                                                    max_tasks_per_child=1) as pool:
            futures = [pool.submit(_run_and_save, *c, *common) for c in todo]
            results = [report(f.result()) for f in concurrent.futures.as_completed(futures)]
    failures = [(a, s, e) for a, s, e, _ in results if e]
    if failures:
        print(f"FAILED {len(failures)} cells:")
        for f in failures:
            print("  ", f)
        return 1
    print(f"all {len(todo)} cells traced OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
