#!/usr/bin/env python3
"""Time the flash attention kernel of this tree against another source of it, in turns.

    git show COMMIT:src/repro_torch/kernels/csrc/flash_attention.cu > build/parent_flash.cu
    python3 flash_profile.py --parent build/parent_flash.cu [--rounds 3] [--reps 50]
    git show COMMIT:src/repro_torch/kernels/csrc/flash_attention_bwd.cu > build/parent_bwd.cu
    python3 flash_profile.py --bwd-parent build/parent_bwd.cu [--parent ...]
    python3 flash_profile.py --plain

Card only.  Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` and
the given source with the port's nvcc flags into ``build/flash_profile/``
(the two in parallel; ``csrc/`` is on the include path, so a copy elsewhere
finds ``flash_common.cuh``) and binds each library's ``ielas_flash_attention_lse``
with a null log-sum-exp, or, in a source from before it, its
``ielas_flash_attention``: a source whose C entry has no ``window`` and
``softcap`` arguments is called without them.  At the shapes ``chip_smoke.py`` times the kernel without
gemma2's options (qwen2.5-32b's width (1, 40, 4096, 128) in bfloat16 and
float32, causal and full; yi-9b's decode (4, 32, 1, Skv, 128), full, at 31
and 4096 keys) it checks that both libraries give the same bits, then times
each in a CUDA graph of ``--reps`` launches (CUDA events around its replay:
device time, no host gap) in turns -- parent, this tree, this tree, parent
-- for ``--rounds`` rounds, and prints the median ms a launch of each and
their ratio.  At gemma2's shapes (its decode, and (1, 32, 8192, 8192,
128) causal with and without the window of 4096; q scaled by 30) it times
this tree alone, with its softcap of 50 and without, in turns.  With
``--bwd-parent`` (repeatable) it first times the backward of this tree
against each given source the same way, in bfloat16 at chip_smoke.py's
training shape (2, 32, 4096, 4096, 128) causal, and prints the largest
difference between the two sources' gradients; without ``--parent`` it
stops there.  Then the
softcap rows' accuracy at two q scales (12 and 30): the bfloat16 kernel's
outputs outside one bfloat16 ulp of the plain version (chip_smoke.py's
FLASH_TOL), and, in float32, the kernel's and the plain version's largest
distance from a float64 softmax on one head.  With ``--plain`` it first
times the plain version (``kernels/ref.py::flash_attention_ref``) at every
flash shape of ``PERF.md``'s kernel table (PLAIN_SHAPES: those above, jamba's
and the stub frontends' serving shapes, gemma2's with its softcap), the
device time of a call: every device row of a torch.profiler trace of
``PLAIN_REPS`` calls over the calls, from two traces whose device
operations agree within one in a hundred (``chip_smoke.py`` times it only
at yi-9b's decode); without ``--parent`` or ``--bwd-parent`` it stops
there.  Every line carries the card's name and power limit.  Imports
nothing of JAX and nothing of ``repro``.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "flash_profile"
# calls of the plain version in one traced timing (--plain)
PLAIN_REPS = 2
# (label, (B, H, Sq, Skv, D), dtype name, causal)
SHAPES = [
    ("qwen2.5-32b bfloat16 causal", (1, 40, 4096, 4096, 128), "bfloat16", True),
    ("qwen2.5-32b bfloat16 full", (1, 40, 4096, 4096, 128), "bfloat16", False),
    ("qwen2.5-32b float32 causal", (1, 40, 4096, 4096, 128), "float32", True),
    ("qwen2.5-32b float32 full", (1, 40, 4096, 4096, 128), "float32", False),
    ("yi-9b decode Skv=31", (4, 32, 1, 31, 128), "bfloat16", False),
    ("yi-9b decode Skv=4096", (4, 32, 1, 4096, 128), "bfloat16", False),
]
# (label, shape, causal, window), each with gemma2's softcap of 50 and
# without it (its cost), bfloat16, q scaled by 30
GEMMA2 = [
    ("gemma2-27b decode Skv=31", (4, 32, 1, 31, 128), False, 0),
    ("gemma2-27b local S=8192", (1, 32, 8192, 8192, 128), True, 4096),
    ("gemma2-27b global S=8192", (1, 32, 8192, 8192, 128), True, 0),
]

# The plain version's shapes: (label, (B, H, Sq, Skv, D), causal, window,
# softcap, q scale), bfloat16 unless the label says float32.
PLAIN_SHAPES = [(label, shape, causal, 0, 0.0, 1.0) for label, shape, _, causal in SHAPES] + [
    ("jamba-1.5-large-398b decode Skv=31", (4, 64, 1, 31, 128), False, 0, 0.0, 1.0),
    ("qwen2-vl-7b prefill", (4, 28, 256, 256, 128), True, 0, 0.0, 1.0),
    ("qwen2-vl-7b decode Skv=272", (4, 28, 1, 272, 128), False, 0, 0.0, 1.0),
    ("musicgen-large prefill", (4, 32, 64, 64, 64), True, 0, 0.0, 1.0),
    ("musicgen-large decode Skv=80", (4, 32, 1, 80, 64), False, 0, 0.0, 1.0),
] + [(label, shape, causal, window, 50.0, 30.0) for label, shape, causal, window in GEMMA2]


def traced_device_ms(torch, fn, reps: int, what: str) -> float:
    """The device time of one call of ``fn``: every device row of a
    torch.profiler trace of ``reps`` calls, summed, over ``reps``.  A trace
    can lose records, so two are taken and count only when their device
    operations agree within one in a hundred (the fuller one gives the
    time); taken again up to five times, then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def rows():
        for _ in range(20):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            found = [(e.self_device_time_total, e.count) for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            if found:
                return found
        raise AssertionError(f"twenty traces of {what} caught no device activity")

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        traces = [rows(), rows()]
        ops = [sum(n for _, n in t) for t in traces]
        if abs(ops[0] - ops[1]) <= max(ops) // 100:
            return sum(t for t, _ in traces[ops.index(max(ops))]) / reps / 1e3
    raise AssertionError(f"five pairs of traces of {what} disagree")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another flash_attention.cu to time against")
    ap.add_argument("--bwd-parent", action="append", default=[],
                    help="another flash_attention_bwd.cu to time the backward against "
                         "(repeatable)")
    ap.add_argument("--plain", action="store_true",
                    help="time the plain version at PLAIN_SHAPES first")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not (args.parent or args.bwd_parent or args.plain):
        ap.error("give --parent, --bwd-parent, --plain or more than one")

    import torch

    if not torch.cuda.is_available():
        print("flash_profile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ref

    card = "[" + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0] + "]"
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def graph_ms(fn) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(args.reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    if args.plain:
        for label, shape, causal, window, softcap, q_scale in PLAIN_SHAPES:
            dtype = torch.float32 if "float32" in label else torch.bfloat16
            b, h, sq, skv, d = shape
            gen = torch.Generator().manual_seed(0)
            q, k, v = ((torch.randn((b, h, n, d), generator=gen) * s_).to(dev, dtype)
                       for n, s_ in ((sq, q_scale), (skv, 1.0), (skv, 1.0)))
            opts = dict(causal=causal, window=window, softcap=softcap)
            ms = traced_device_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **opts),
                                  PLAIN_REPS, f"the plain flash {label}")
            print(f"plain flash {label} {shape} {str(dtype).removeprefix('torch.')} causal="
                  f"{causal} window={window} softcap={softcap}: {ms:.4f} ms device a call "
                  f"(torch.profiler, {PLAIN_REPS} calls) {card}", flush=True)
            del q, k, v
            torch.cuda.empty_cache()
        if not (args.parent or args.bwd_parent):
            return 0

    OUT.mkdir(parents=True, exist_ok=True)
    for parent in args.bwd_parent:
        _profile_backward(torch, _build, Path(parent), graph_ms, args.rounds, args.reps, dev,
                          card)
    if not args.parent:
        return 0

    sources = {"parent": Path(args.parent), "this tree": _build.CSRC / "flash_attention.cu"}
    jobs = {}
    for key, src in sources.items():
        so = OUT / f"{key.replace(' ', '_')}.so"
        jobs[key] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                                           str(_build.CSRC), "-o", str(so), str(src)],
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    fns, with_options, with_lse = {}, {}, {}
    for key, (so, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {sources[key]}:\n{text}")
        entry = re.search(r'extern "C" int (ielas_flash_attention(?:_lse)?)\(([^)]*)\)',
                          sources[key].read_text())
        if entry is None:
            raise RuntimeError(f"no flash entry point in {sources[key]}")
        with_lse[key] = entry.group(1).endswith("_lse")
        with_options[key] = "window" in entry.group(2)
        fn = getattr(ctypes.CDLL(str(so)), entry.group(1))
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * (5 if with_lse[key] else 4)
                       + [ctypes.c_int] * (7 if with_options[key] else 6)
                       + [ctypes.c_float] * (2 if with_options[key] else 1) + [ctypes.c_void_p])
        fns[key] = fn

    def launch(key, q, k, v, out, causal, window=0, softcap=0.0):
        b, h, sq, d = q.shape
        dtype = 1 if q.dtype == torch.bfloat16 else 0
        stream = torch.cuda.current_stream().cuda_stream
        head = ((q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
                + ((None,) if with_lse[key] else ())
                + (b * h, sq, k.shape[2], d, dtype, int(causal)))
        if with_options[key]:
            err = fns[key](*head, window, 1.0 / math.sqrt(d), softcap, stream)
        else:
            if window or softcap:
                raise ValueError(f"{key} has no window or softcap")
            err = fns[key](*head, 1.0 / math.sqrt(d), stream)
        if err:
            raise RuntimeError(f"{key}: launch failed, cudaError_t {err}")

    def inputs(shape, dtype, q_scale=1.0, seed=0):
        b, h, sq, skv, d = shape
        gen = torch.Generator().manual_seed(seed)
        return [(torch.randn((b, h, n, d), generator=gen) * s).to(dev, dtype)
                for n, s in ((sq, q_scale), (skv, 1.0), (skv, 1.0))]

    for label, shape, dname, causal in SHAPES:
        q, k, v = inputs(shape, getattr(torch, dname))
        outs = {key: torch.empty_like(q) for key in fns}
        for key in fns:
            launch(key, q, k, v, outs[key], causal)
        torch.cuda.synchronize()
        same = torch.equal(outs["parent"], outs["this tree"])
        times = {key: [] for key in fns}
        for _ in range(args.rounds):
            for key in ("parent", "this tree", "this tree", "parent"):
                times[key].append(graph_ms(lambda: launch(key, q, k, v, outs[key], causal)))
        med = {key: sorted(t)[len(t) // 2] for key, t in times.items()}
        print(f"flash {label} {shape} {dname}: outputs {'bitwise equal' if same else 'DIFFER'}; "
              f"parent {med['parent']:.4f} ms, this tree {med['this tree']:.4f} ms a launch "
              f"(median of {len(times['parent'])}, CUDA graph of {args.reps}; this tree / parent "
              f"{med['this tree'] / med['parent']:.3f}) {card}", flush=True)
        if not same:
            raise AssertionError(f"{label}: the two sources give other bits")
        del q, k, v, outs
        torch.cuda.empty_cache()

    for label, shape, causal, window in GEMMA2:
        q, k, v = inputs(shape, torch.bfloat16, q_scale=30.0, seed=2)
        out = torch.empty_like(q)
        times = {cap: [] for cap in (0.0, 50.0)}
        for _ in range(args.rounds):
            for cap in (0.0, 50.0, 50.0, 0.0):
                times[cap].append(graph_ms(
                    lambda: launch("this tree", q, k, v, out, causal, window, cap)))
        med = {cap: sorted(t)[len(t) // 2] for cap, t in times.items()}
        print(f"flash {label} {shape} bfloat16 window {window}: this tree with softcap 50 "
              f"{med[50.0]:.4f} ms, without {med[0.0]:.4f} ms a launch (median of "
              f"{len(times[0.0])}, in turns; the cap costs x{med[50.0] / med[0.0]:.3f}) {card}",
              flush=True)
        del q, k, v, out
        torch.cuda.empty_cache()

    def float64_attention(q, k, v, window, softcap):
        """One head's (1, 1, S, D) softmax attention in float64, as the plain
        version computes it."""
        q, k, v = (t.double() for t in (q, k, v))
        s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        s = softcap * torch.tanh(s / softcap)
        i = torch.arange(s.shape[-2], device=dev)[:, None]
        j = torch.arange(s.shape[-1], device=dev)[None, :]
        ok = (j <= i) & ((i - j < window) if window else True)
        return torch.softmax(torch.where(ok, s, -1e30), dim=-1) @ v

    for q_scale in (12.0, 30.0):
        for label, shape, causal, window in GEMMA2[1:]:
            q, k, v = inputs(shape, torch.bfloat16, q_scale=q_scale, seed=2)
            out = torch.empty_like(q)
            launch("this tree", q, k, v, out, causal, window, 50.0)
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                           softcap=50.0).float()
            diff = (out.float() - want).abs()
            bad = diff > 1e-5 + 2.0 ** -7 * want.abs()
            worst = bad.flatten(2).any(-1).nonzero()          # (B, H) pairs with an outlier
            head = int(worst[0, 1]) if len(worst) else 0
            q32, k32, v32 = (t[:, head:head + 1].float().contiguous() for t in (q, k, v))
            out32 = torch.empty_like(q32)
            launch("this tree", q32, k32, v32, out32, causal, window, 50.0)
            plain32 = ref.flash_attention_ref(q32, k32, v32, causal=causal, window=window,
                                              softcap=50.0)
            exact = float64_attention(q32, k32, v32, window, 50.0)
            print(f"flash {label} softcap 50, q x {q_scale}: bfloat16 {int(bad.sum())} of "
                  f"{bad.numel()} outside one ulp of the plain version (max {float(diff.max()):.3g}"
                  f"); float32 on head {head}: kernel {float((out32 - exact).abs().max()):.3g}, "
                  f"plain {float((plain32 - exact).abs().max()):.3g} from float64 {card}",
                  flush=True)
            del q, k, v, out, want, diff, bad, q32, k32, v32, out32, plain32, exact
            torch.cuda.empty_cache()
    return 0


# (label, (B, H, Sq, Skv, D), causal): the backward at chip_smoke.py's
# training shape (FLASH_BWD_TRAIN), bfloat16.
BWD_SHAPES = [
    ("yi-9b training microbatch bfloat16 causal", (2, 32, 4096, 4096, 128), True),
]


def _profile_backward(torch, _build, parent: Path, graph_ms, rounds: int, reps: int, dev,
                      card: str) -> None:
    """Time this tree's ``ielas_flash_attention_bwd`` against the one in
    ``parent`` (same C signature; the scratch is sized for this tree's,
    which is the larger) in turns -- parent, this tree, this tree, parent --
    on the output and log-sum-exp of this tree's forward, and print the
    median ms a call of each, their ratio and the largest difference
    between their gradients."""
    from repro_torch.kernels import flash_attention as flash_kernel

    sources = {"parent": parent, "this tree": _build.CSRC / "flash_attention_bwd.cu"}
    jobs = {}
    for key, src in sources.items():
        so = OUT / f"bwd_{key.replace(' ', '_')}_{parent.stem}.so"
        jobs[key] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                                           str(_build.CSRC), "-o", str(so), str(src)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    fns = {}
    for key, (so, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {sources[key]}:\n{text}")
        fn = ctypes.CDLL(str(so)).ielas_flash_attention_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = flash_kernel.BWD_ARGTYPES
        fns[key] = fn
    for label, (b, h, sq, skv, d), causal in BWD_SHAPES:
        gen = torch.Generator().manual_seed(1)
        q, k, v, g = ((torch.randn((b, h, n, d), generator=gen)).to(dev, torch.bfloat16)
                      for n in (sq, skv, skv, sq))
        out, lse = flash_kernel._forward(q, k, v, causal, 0, 0.0, with_lse=True)
        scratch = torch.empty(2 * b * h * (-(-sq // 4) * 4), dtype=torch.float32, device=dev)
        grads = {key: [torch.empty_like(t) for t in (q, k, v)] for key in fns}

        def launch(key):
            dq, dk, dv = grads[key]
            err = fns[key](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           g.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), b * h, sq, skv, d, 1, int(causal), 0,
                           1.0 / math.sqrt(d), 0.0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{key}: backward launch failed, cudaError_t {err}")

        for key in fns:
            launch(key)
        torch.cuda.synchronize()
        diff = max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(grads["parent"], grads["this tree"]))
        times = {key: [] for key in fns}
        for _ in range(rounds):
            for key in ("parent", "this tree", "this tree", "parent"):
                times[key].append(graph_ms(lambda: launch(key)))
        med = {key: sorted(t)[len(t) // 2] for key, t in times.items()}
        print(f"flash backward {label} {(b, h, sq, skv, d)} against {parent}: parent "
              f"{med['parent']:.4f} ms, this tree {med['this tree']:.4f} ms a call (median of "
              f"{len(times['parent'])}, CUDA graph of {reps}; this tree / parent "
              f"{med['this tree'] / med['parent']:.3f}); largest gradient difference {diff:.4g} "
              f"{card}", flush=True)
        del q, k, v, g, out, lse, scratch, grads
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
