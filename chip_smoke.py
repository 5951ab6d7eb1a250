#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of iELAS on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs nvcc and one card

Phases (any failure exits nonzero):
 1. device: card name and count, ``nvidia-smi`` name and power limit, versions;
 2. build: compile every ``src/repro_torch/kernels/csrc/*.cu`` in parallel
    (the flash forward and its backward are two of them);
    the flash forward's and the backward's libraries' SASS must each hold
    HGMMA (bf16 on the tensor cores);
 3. kernels: each CUDA kernel against its plain PyTorch version on the card,
    at the shapes the frame path and the wave give it (elas-kitti,
    elas-tsukuba, and disp_min=4 dense cases), with 0 mismatches allowed
    (flash attention: within the tolerance stated at FLASH_TOL):
    the kernels' float32 exp/log (exhaustive over the log's input range),
    the warm kernel's reciprocal (exhaustive over [1, 2^126)),
    support search, streaming and candidate-window dense matching, Sobel,
    median; on a wave of four different pairs the support, streaming and
    candidate-window kernels against the plain version on the same stacked
    inputs and slot by slot against a per-frame launch, Sobel on both views
    of the wave and the median on the wave's maps; the warm band kernel on a
    frame of a pan seeded by the card's cold output of the frame before
    (band 8, timed, with the share of right-view candidates whose SAD a
    left-view candidate also needs; bands 0 and 2; bands pushed to either
    end of the range; an all-invalid prior; a stack of four frames against
    the plain version and against per-frame launches); the support kernel at
    every split of a row into spans (1, 2, 4, 8 blocks a row) and on the
    candidate rows' strided views; both dense kernels, the support kernel
    (at every split), the Sobel kernel (uint8, int32 and float32 stacks at
    byte offsets 0-15), the median kernel (stacks of two maps at float
    offsets 0-3: thin maps, odd widths, all-invalid and invalid-free maps)
    and the warm kernel (sigma 1 and 1.5) on every case of
    ``tests/torch_kernel_cases.py``;
    kernel, plain and bound times (every kernel time from a profiler row of
    that kernel's symbol; the plain versions' and SDPA's, the device time of
    a call: the device rows of two agreeing traces for the plain stereo
    versions and the plain flash (hundreds to thousands of launches a
    call: XLA's exp and FMAs in float64 steps), CUDA events around calls
    queued behind a spin kernel for SDPA and the plain versions of a few;
    a plain version is timed only in the case the summary's line shows,
    SHOWN: ``dense_profile.py --plain`` and ``flash_profile.py --plain``
    time it at the other shapes);
    flash attention at qwen2.5-32b's width against its plain version, with
    ``F.scaled_dot_product_attention``'s time, and how many of its outputs
    lie outside FLASH_TOL of the plain version, beside it as a yardstick;
    flash in bfloat16 at yi-9b's serving shapes (decode: B=4, H=32, one query
    against 1, 17, 31 and 4096 keys, full; prefill-shaped 16 x 16, causal)
    and at jamba-1.5-large-398b's decode (B=4, H=64, 31 keys), the decode
    shapes of 31 and 4096 keys timed with the kernel's byte bound, the path's
    (yi-9b's 4, jamba's 8 KV heads read once) and SDPA's time; flash at the
    stub-frontend backbones' shapes, each timed with its bound, the path's
    and SDPA's time: qwen2-vl-7b's 28 query heads (prefill (4, 28, 256, 256,
    128) causal, decode (4, 28, 1, 272, 128)) and musicgen-large's head width
    64 (prefill (4, 32, 64, 64, 64) causal, decode (4, 32, 1, 80, 64)); flash in
    bfloat16 at gemma2-27b's shapes with its softcap of 50 (q scaled so that
    scores span about +-150): decode (4, 32, 1, 31, 128), full; prefill-shaped
    (1, 32, 8192, 8192, 128), causal, with the local layers' window of 4096
    and without (the global layers), each timed with the bound over its
    visible pairs, the plain version's device time and a compiled
    ``flex_attention``'s (softcap score_mod, window block mask: a yardstick;
    its failure to compile is printed, not raised); and the options' edge
    cases at S = 640 in bfloat16 and float32 (windows 100 and 4097, with and
    without the softcap, the softcap alone); flash at the examples' head
    widths 32 and 16 (FLASH_EXAMPLE_SHAPES) in bfloat16 and float32, causal
    and full, against its plain version;
 4. single frame: ``ielas_disparity`` for elas-kitti and elas-tsukuba, one
    warm-up frame and five timed frames each, with the support, stream,
    Sobel and median launch counts rising by one per frame; per-stage and
    end-to-end times, the bad-pixel rate against the synthetic ground
    truth, the output against the port's CPU output of the same frame (0
    mismatches), and one profiled frame (device busy share, kernels by time);
 5. wave: the wave-shaped stages (``ielas_support_stage_batched``,
    interpolation per slot, ``ielas_dense_stage_batched``) for elas-kitti
    and elas-tsukuba on four different pairs, on the stream route
    (``tile=None``) and the candidate route (``TileSpec(gather="take")``):
    every slot equal to the card's single-frame output of its pair, one
    launch of each kernel of the route per wave, per-stage and wave times,
    frames per second and one profiled wave;
 6. golden frame: the card's output against the port's CPU output (0
    mismatches) and the pinned sha256;
 7. attention: the port's ``flash_attention`` entry point at qwen2.5-32b's
    attention width (B=1, H=40, S=4096, D=128), causal and not, float32 and
    bfloat16, one launch a call, each output equal to phase 3's;
 8. service: ``StereoService(device="cuda")`` for elas-kitti and
    elas-tsukuba, batch 4, two streams of 8 frames (seeds 0-15) after
    ``warmup()``: every frame equal to the card's single-frame output of its
    pair, each stream in submission order, no cache miss, the support,
    Sobel, stream and median launches one per wave; waves, occupancy,
    latency and frames/s against phase 5's bare wave, and the same burst
    once more under the profiler; then a ``FaultPlan``
    that fails one wave's dense stage once (its frames retried, still
    equal) and poisons one frame (delivered with ``error`` while its
    wave-mates recover); then ``repro_torch.launch.serve stereo`` once;
 9. warm video: a 5-frame pan at elas-kitti's full size with a scene cut at
    frame 3 through ``StereoService(batch=1, warm_start=True,
    device="cuda")``, one frame at a time (submit, then ``collect(1)``), at
    the default post-hoc bound (``rerun_threshold=0.15``) and at 0.5:
    every delivered frame equal to the port's CPU service's on the same
    sequence, the warm counters equal to the CPU run's and to the sequence's
    shape (2 cold frames, 1 scene change, 3 warm frames), the launches of
    each kernel as the warm, cold and re-run frames dictate; the warm and
    cold frames' latency, and the warm and cold dense stage's time (CUDA
    events) on the same frame;
10. hybrid baseline: ``elas_baseline_disparity`` (host-side Delaunay
    priors) for elas-kitti and elas-tsukuba on phase 4's pairs, one warm-up
    frame and three timed frames each, with the support, stream, Sobel and
    median launch counts rising by one per frame; the support stage (CUDA
    events), the host part (the grids' copies, two ``delaunay_prior`` calls,
    the priors' copies back; host clock) and the dense half (CUDA events);
    frames per second and the bad-pixel rate beside phase 4's
    ``ielas_disparity``; the output against the port's CPU output of the
    same frame (0 mismatches);
11. LM serving: yi-9b at full width (48 layers, bfloat16, seeded weights
    made on the card by ``LMModel.init``) through ``ServeEngine(batch=4,
    max_len=33)``: 8 requests of 4-16 prompt tokens and 16 new tokens each,
    every request served in range, a second ``generate`` equal, flash
    launched once per layer per decode step and nothing else; tokens/s, the
    decode step's median (CUDA events), memory allocated and one profiled
    step (device busy share, flash's and the matmuls' shares, and the KV
    expansion's, traced alone at the step's shapes); wave 0 again through
    the kernel and with the attention's kernel call swapped for the plain
    version (in this script only): with equal inputs on both paths the
    logits within LM_LOGIT_ULPS bfloat16 steps of the binade of the largest
    second-best logit (delta; a tied head's logit of the input token, delta
    plus one step of its own binade), and every token whose plain top-2 logit margin
    exceeds 2 * delta equal; the reduced model in float32 on the card against the port's CPU
    run (equal tokens; logits within LM_F32_TOL over LM_F32_STEPS tokens
    without a cache and through float32 caches); ``repro_torch.launch.serve
    lm --device cuda`` once;
12. the same for gemma2-27b at full width (46 layers alternating a 4096
    sliding window and global attention, softcaps 50 and 30, post-block
    norms, tied embeddings; 27,227,128,320 parameters, ~50.7 GiB in
    bfloat16), made after phase 11's model is freed; its logit cap rounds
    nearly every greedy token's top logits to a tie at 30.0, so the kernel
    path is held to the plain path by the logits before the cap;
13. the same for deepseek-v2-lite-16b at full width (27 MLA layers, the
    first with a dense MLP, the rest static-capacity MoE of 64 routed
    experts, top-6, and 2 shared; 15,706,470,400 parameters, 29.26 GiB):
    no flash launch (MLA's attention is plain PyTorch), no token dropped by
    the MoE at any decode step, no kernel-vs-plain comparison (nothing to
    swap); the reduced float32 model against the CPU and ``serve lm --arch
    deepseek-v2-lite-16b`` as in phase 11;
14. deepseek-v2-236b cut to its first LM_CUT_LAYERS = 4 layers at full
    widths (q-LoRA queries, 160 experts; 13,302,903,808 parameters, 24.78
    GiB): one wave of 4 requests, no flash launch, no token dropped, a
    profiled step, the reduced float32 model against the CPU, and ``serve lm
    --arch deepseek-v2-236b`` (its reduced model);
15. jamba-1.5-large-398b cut to its first LM_CUT_LAYERS = 4 layers at full
    widths, its 8-layer unit cut with them (``pattern_unit[:4]``: Mamba + MLP,
    Mamba + MoE, Mamba + MLP, attention + MoE of 16 experts, top-2;
    23,021,379,584 parameters, 42.88 GiB; memory after ``init`` and its
    peak): one wave of 4 requests, flash launched once a decode step (the
    attention layer), no token dropped, a profiled step (flash's, the
    matmuls' and the Mamba mixers' shares, one mixer traced alone), the
    kernel path against the plain-attention path as in phase 11 up to each
    request's first step whose experts differ (that flip must be a near tie,
    FLIP_MARGIN, on the plain path's router), the reduced float32 model
    against the CPU and ``serve lm --arch jamba-1.5-large-398b``;
16. xlstm-350m at full width (24 layers, 21 mLSTM and 3 sLSTM; 528,729,256
    parameters, 0.98 GiB) as in phase 11: no flash launch, no kernel-vs-plain
    comparison (nothing to swap); then a float32 copy of the model over
    XLSTM_CHUNKED_S = 128 positions without a state (the chunked mLSTM, two
    chunks a layer) against as many decode steps through the states, within
    XLSTM_CHUNKED_TOL;
17. qwen2-vl-7b at full width (28 layers, M-RoPE, qkv biases; 7,615,616,512
    parameters, 14.19 GiB): 4 sequences of 256 seeded patch embeddings with
    the (t, h, w) positions of a 16 x 16 grid prefilled into caches of 273
    positions through ``LMModel.apply``, then 16 greedy decode steps of token
    ids through ``decode_step``: flash launched once per layer for the
    prefill and per step; the prefill's and the steps' times, tokens/s,
    memory, a profiled step; the prefill's and every step's logits on the
    kernel path against the plain-attention path on the same tokens (within
    LM_LOGIT_ULPS bfloat16 steps, tokens equal above 2 * delta); the reduced
    float32 model against the port's CPU run on embeddings without a cache
    and through a prefill and 8 decode steps;
18. the same for musicgen-large (48 layers, 32 heads of 64, sinusoidal
    positions, a plain GeLU MLP; 2,424,506,368 parameters, 4.52 GiB) on 64
    frame embeddings and caches of 81 positions;
19. training: (a) the flash backward kernel (``csrc/flash_attention_bwd.cu``
    through the kernel's autograd Function) against autograd through the
    plain version at FLASH_BWD_CASES (causal, full, gemma2's window and
    softcap, D = 64, a ragged S; float32 and bfloat16; bfloat16 also at
    D = 32 and 16), 0 gradient entries outside FLASH_BWD_TOL_F32 /
    FLASH_BWD_ULPS allowed, and a second backward call on the same inputs
    must give the same bits (the replay in (d) relies on it); (b) the backward at
    the training shape FLASH_BWD_TRAIN, held to the plain version and timed
    from its three kernels' profiler rows beside its bound, the plain
    backward's device time and SDPA's backward; (c) yi-9b-reduced and
    gemma2-27b-reduced in float32: the loss and every gradient on the card
    (flash forward and backward kernels) against the port's CPU run, and
    every wq / wk / wv gradient non-zero; (d) yi-9b at full widths cut to
    its first TRAIN_LAYERS = 8 layers (1.91e9 parameters, bf16, float32
    AdamW moments) through ``Trainer``: a global batch of 4 x 4096 in 2
    microbatches, 6 steps, a checkpoint every 2, one injected
    ``SimulatedNodeFailure`` before step 3's batch whose replayed step must
    give the same loss bit for bit; step times, tokens/s, memory, flash
    forward and backward launches (under remat, the default, each layer's
    forward runs twice: 32 and 16 a step) and one profiled step; (e) remat
    on the card: one microbatch's loss and every gradient of that model with
    remat and without bit-equal, each run's peak memory above its start, and
    the flash forward at the training shape giving its output and
    log-sum-exp bit for bit again (what the recomputation relies on); then
    ``python -m repro_torch.launch.train`` once on the card;
20. the mesh: a world-1 NCCL group (a FileStore under build/) and a (1, 1)
    ("data", "model") DeviceMesh on the card, the rules of ``make_rules``:
    phase 19's 8-layer yi-9b at full widths, one ``Trainer`` step on phase
    19's first batch and seed without the mesh, then the same step with the
    parameters and AdamW moments laid out by ``shard_model`` under
    ``use_mesh`` and ``use_rules`` (both flash kernels launched on the
    DTensors' local shards): loss, metrics and every parameter after the step
    and AdamW moments bit-equal (the step's rate is not 0: no warmup); the
    step's device time (profiler) with and without the mesh;
    ``elastic_reshard`` of the trained parameters onto a (1, 1, 1) ("pod",
    "data", "model") mesh, a checkpoint of them and ``restore(sharding_tree=
    ...)`` onto that mesh, every leaf bit-equal in the placements its rules
    give; then phase 11's yi-9b (48 layers) through ``ServeEngine`` on its
    first wave (prompts cut to MESH_PROMPT tokens) for MESH_NEW tokens without
    and under the mesh: every decode
    step's logits bit-equal, the tokens equal, flash launched once per layer
    per step, and the DTensor dispatch overhead per decode step (host clock);
    the phase's wall time;
21. the dry run: ``launch/dryrun.run_cell`` on a fake process group of 256
    ranks and a fake ``cuda`` (16, 16) mesh (nothing is allocated on the
    card) for yi-9b x decode_32k and yi-9b x prefill_32k (DRYRUN_CELLS): the
    flash ops traced and counted (48 forward calls a step, their flops those
    of the formula at the local shapes), no kernel launched, each meter's
    totals (per-device flops, collective bytes by kind, MemTracker's memory)
    and a peak below 80 GiB a device;
22. the examples: each of ``examples/torch_*.py`` through its ``main`` on the
    card at the reference's defaults, plus ``torch_train_lm`` at its 100m
    preset for EXAMPLE_TRAIN_STEPS steps and ``torch_stereo_serving`` at
    375x1242 with 4 streams x 4 frames: the quickstart's iELAS and baseline
    maps equal to the port's CPU output (0 mismatches), every served frame
    equal to the card's single-frame output of its pair, the launch counts
    (one support, Sobel, stream and median launch a frame or wave; one flash
    launch a layer a decode step in LM serving; one backward launch a layer a
    microbatch a step in training), training's ce falling, the fault demo's 2
    recoveries with a parameter diff of exactly 0.0 between distinct tensors
    and its heartbeat verdicts; fps, tokens/s and s/step; then ``python
    examples/torch_quickstart.py`` once in a subprocess; the phase's wall time;
23. a JSON line of per-kernel numbers, then ``{"ok": true, "device": ...}``.

Each phase prints how far into the run it starts.

Every time is printed with the card's name and power limit.  Each profiled
frame or wave also leaves its device-side rows, by time, in
``build/traces/profile-<label>.txt``.  Imports
nothing of JAX and nothing of the reference package ``repro``.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor
# float32 rate, used here for every 32-bit scalar operation (integer rates
# are no higher, so the bound stays a lower bound on time).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Scalar operations per unit of work.  A 16-lane SAD: 16 differences, 16
# absolute values, 15 adds.  A 4-deep register insert: 4 compares, 8 selects.
# XLA's float32 exp: clamp (2), 9 FMAs, floor, square, add, convert, 3
# integer ops for the two power-of-two factors, 2 multiplies, flush (20); its
# log: mantissa/exponent split (4), compare and 2 selected ops, 2 multiplies,
# 10 FMAs, a multiply, an add (22).  A dense candidate's energy: subtract,
# square, negate, divide, add gamma, exp, log, negate, convert, FMA, and the
# compare-and-keep (9 + exp + log).  The dense bounds count the work every
# implementation must do: each distinct in-image candidate of a pixel and
# view once (a SAD and an energy).  Printed beside them, as the scan's and
# the slots' bounds: the same work plus a mask test for every (pixel, d,
# view) of a scan -- a bitmask load, two band compares, a bounds compare
# (4) -- or an energy for every in-image slot of a window and a test for
# every slot -- a candidate load, its column, two bounds compares (4).  A
# Sobel pixel (both maps): 12 adds and shifts per map, floor shift and two
# clamps per map (30).  A median pixel: 19 min/max pairs and 9
# compare-and-selects (56).
OPS_SAD = 47
OPS_INSERT4 = 12
OPS_EXP = 20
OPS_LOG = 22
OPS_ENERGY = 9 + OPS_EXP + OPS_LOG
OPS_MASK = 4
OPS_SLOT = 4
OPS_SOBEL = 30
OPS_MEDIAN = 56
# A warm candidate's energy: subtract, square, FMA, divide, negate, convert,
# FMA, and the compare-and-keep (8).  The warm bound counts each distinct
# (left column, d) SAD once over the union of both views' bands (right pixel
# u at d and left pixel u + d at d need the same SAD) and each in-image band
# candidate's energy; printed beside it, the bound that counts a SAD for
# every candidate.
OPS_WARM_ENERGY = 8

GOLDEN_SHA256 = "91e3ce9df8a9d01f9b9905bd2aabe4f0791dd06329e1c6f015557054988c018b"
# Card vs CPU output.  The dense energy is one float32 sequence on both
# devices (XLA:CPU's exp/log polynomials with explicit FMAs; kernels/ref.py
# and kernels/csrc/xla_math.cuh), so every pixel must agree.
GOLDEN_TOLERANCE = 0      # pixels of 57 x 83
FRAME_TOLERANCE = 0       # share of a full frame's pixels
WAVE = 4                  # frames per wave (seeds 0-3)

# Flash attention at qwen2.5-32b's attention width (src/repro/configs/
# qwen2_5_32b.py: 40 heads of 128; k and v with 40 heads too, as the
# kernel has no grouped-query attention): (B, H, S, D).
FLASH_SHAPE = (1, 40, 4096, 128)
# The kernel sums in another order than the plain version (tiles of keys
# with online-softmax rescaling; in bfloat16 P V is the sum of two
# tensor-core products, of P's bf16 high and low halves), so they agree
# within a tolerance, checked elementwise as |kernel - plain| <= atol +
# rtol * |plain|.  float32: the reference's own test tolerance
# (tests/test_flash_attention.py); sums of at most 4096 terms below 1 in
# float32 differ by ~1e-6.  bfloat16: both round float32 results that
# differ by ~1e-6 to bfloat16, so they differ by at most one bfloat16 ulp,
# which is at most 2**-7 of the value.
FLASH_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (1e-5, 2.0 ** -7)}
# Dense peaks of the H100 SXM for the flash bound: the bf16 tensor-core
# rate and the float32 rate of the CUDA cores (NVIDIA H100 datasheet).
FLASH_PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# Flash at the LM serving path's shapes: yi-9b (src/repro/configs/yi_9b.py)
# after the GQA expansion, 32 heads of 128, batch 4.  Decode is one query
# against the cache's valid prefix, full attention: (B, H, Sq, Skv, D).
FLASH_DECODE = [(4, 32, 1, skv, 128) for skv in (1, 17, 31)]
FLASH_PREFILL = (4, 32, 16, 16, 128)
# A decode step at a cache length users serve (phase 11's cache holds at most
# 33 positions): one query against 4096 keys.  Timed with the longest of
# FLASH_DECODE, each beside two byte bounds: the kernel's (q, the expanded k
# and v, out) and the path's (q, yi-9b's 4 KV heads' prefix unexpanded, out),
# which a kernel reading each KV head once for its query heads could reach.
FLASH_DECODE_LONG = (4, 32, 1, 4096, 128)
LM_KV_HEADS = 4           # yi-9b's KV heads: each serves 8 of the 32 query heads
# Flash at jamba-1.5-large-398b's decode on phase 15's path (src/repro/configs/
# jamba_1_5_large_398b.py: 64 query heads of 128 after the GQA expansion of
# its 8 KV heads), one query against the smoke's longest cache prefix, full.
FLASH_JAMBA_DECODE = (4, 64, 1, 31, 128)
JAMBA_KV_HEADS = 8
FLASH_DECODE_TIMED = (FLASH_DECODE[-1], FLASH_DECODE_LONG, FLASH_JAMBA_DECODE)
# The stub-frontend backbones' serving shapes (phases 17-18): batch 4, the
# frontend's embeddings prefilled into the caches, then FRONTEND_NEW greedy
# decode steps of token ids.  qwen2-vl-7b (src/repro/configs/qwen2_vl_7b.py:
# 28 query heads of 128 after the GQA expansion of its 4 KV heads, M-RoPE) on
# the 256 patches of a 16 x 16 grid; musicgen-large (src/repro/configs/
# musicgen_large.py: 32 heads of 64, MHA, sinusoidal positions) on 64 audio
# frames.  Flash at their prefill (causal) and at their longest decode step
# (full attention over the prefill and FRONTEND_NEW tokens), each timed beside
# its bound and SDPA's time (phase 3).
FRONTEND_BATCH = 4
FRONTEND_NEW = 16
QWEN_VL_GRID = 16
MUSICGEN_FRAMES = 64
QWEN_VL_KV_HEADS = 4
FLASH_FRONTEND = (("qwen2-vl-7b", QWEN_VL_KV_HEADS, (4, 28, 256, 256, 128), (4, 28, 1, 272, 128)),
                  ("musicgen-large", 32, (4, 32, 64, 64, 64), (4, 32, 1, 80, 64)))
# Flash at gemma2-27b's shapes (src/repro/configs/gemma2_27b.py: 32 query
# heads of 128 after the GQA expansion of its 16 KV heads, a score softcap of
# 50 on every layer, a sliding window of 4096 on every other).  Decode is
# full attention over the smoke's longest cache prefix; prefill-shaped is
# causal over 8192 positions, the local layers' window and the global
# layers' whole triangle.  The plain version's float32 scores at 8192 take
# 8.6 GB each (~35 GB at its peak), so these run before any model is loaded.
GEMMA2_SOFTCAP = 50.0
GEMMA2_WINDOW = 4096
GEMMA2_KV_HEADS = 16
FLASH_GEMMA2_DECODE = (4, 32, 1, 31, 128)
FLASH_GEMMA2_PREFILL = (1, 32, 8192, 8192, 128)
# q scaled by 30: scaled scores of std 30 span about +-150 over 8192 keys, so
# the cap of 50 bites (the seeded model's scores are near N(0, 1), where it
# never would).
FLASH_CAP_Q_SCALE = 30.0
# The options' edge cases at S = 640 (five query tiles), bfloat16 and
# float32: (window, softcap), a window inside a key tile and one wider than
# the keys, each with and without the softcap, and the softcap alone.
FLASH_GEMMA2_EDGE_S = 640
FLASH_GEMMA2_EDGES = [(100, GEMMA2_SOFTCAP), (4097, GEMMA2_SOFTCAP), (0, GEMMA2_SOFTCAP),
                      (100, 0.0), (4097, 0.0)]
# The flash forward at the examples' head widths (phase 22), held to its plain
# version in both dtypes, causal and full: D = 32 (examples/torch_lm_serving.py
# and torch_train_lm.py's fast preset, d_model 128 over 4 heads; a microbatch of
# 4 sequences of 128) and D = 16 (torch_fault_tolerance_demo.py, 64 over 4; 4
# sequences of 64), and a decode step at D = 32 (one query against 55 keys).
FLASH_EXAMPLE_SHAPES = [(4, 4, 128, 128, 32), (4, 4, 64, 64, 16), (4, 4, 1, 55, 32)]
SERVICE_STREAMS = 2       # streams of the service phase
SERVICE_FRAMES = 8        # frames per stream (seeds 0-15)
WARM_BAND = 8             # the service's default warm band
VIDEO_FRAMES = 5          # frames of the warm video phase
VIDEO_CUT = 3             # its scene cut
BASELINE_FRAMES = 4       # the hybrid baseline: one warm-up frame and three timed
# LM serving (phases 11-16): yi-9b, gemma2-27b and deepseek-v2-lite-16b, each
# at full width, all layers, bfloat16, seeded weights; ServeEngine(batch=4,
# max_len=33) on 8 requests of 4-16 prompt tokens (np.random.default_rng(0),
# drawn as the launcher's serve_lm draws them) and 16 new tokens each; then,
# each cut to its first LM_CUT_LAYERS layers at full widths and run on the
# first 4 requests, deepseek-v2-236b (439 GiB in bfloat16, more than the
# card: one dense layer, three MoE of 160 experts; 13,302,903,808
# parameters, 24.78 GiB) and jamba-1.5-large-398b (742 GiB: Mamba + MLP,
# Mamba + MoE, Mamba + MLP, attention + MoE of 16 experts; its 8-layer unit
# cut to 4; 23,021,379,584 parameters, 42.88 GiB); then xlstm-350m at full
# width as the first three.
LM_CUT_LAYERS = 4
LM_ARCHS = (("yi-9b", 0), ("gemma2-27b", 0), ("deepseek-v2-lite-16b", 0),
            ("deepseek-v2-236b", LM_CUT_LAYERS), ("jamba-1.5-large-398b", LM_CUT_LAYERS),
            ("xlstm-350m", 0))
# xlstm-350m's chunked mLSTM (phase 16): a float32 copy of the model over
# XLSTM_CHUNKED_S positions without a state (two chunks of 64 a layer)
# against as many decode steps through the states, within the CPU tests'
# tolerance (tests/test_torch_xlstm.py: 5.5e-6 seen on the CPU at full width
# on logits up to 5.3, 1.4e-6 reduced).
XLSTM_CHUNKED_S = 128
XLSTM_CHUNKED_TOL = (1e-5, 1e-5)
LM_BATCH = 4
LM_REQUESTS = 8
LM_PROMPT_LEN = 16
LM_NEW = 16
LM_MAX_LEN = LM_PROMPT_LEN + LM_NEW + 1
# The kernel path against the plain-attention path on the same wave.  The
# kernel's attention outputs are within one bfloat16 ulp of the plain
# version's (FLASH_TOL); the rest of the model is the same code on the same
# card.  The head's output is bfloat16, so a logit moves in steps of one
# bfloat16 ulp of its binade: allowing the one-ulp differences to move the
# logits before any softcap by up to LM_LOGIT_ULPS such steps of the binade
# of the largest second-best logit of the wave's steps (delta), every step
# with equal inputs on both paths must keep its logits within delta.  yi-9b's
# top logits lie in [4, 8): steps of 2^-5, delta 0.125.  The second-best,
# not the best: gemma2-27b's seeded residual stream is ~sqrt(d_model) = 68
# times the input token's embedding, so that token's own tied logit is
# ~d_model = 4608, 13 times any other, whose 4 steps (128) would bound
# nothing; its other pre-cap logits (unit-normal rows against the normed
# state, std ~68) reach ~350, in [256, 512): steps of 2, delta 8.  That one
# self-logit of a tied head (the step's input token's) is rounded to bfloat16
# in steps of its own binade (32 at 4608), so a difference within delta in
# the float32 sum before that rounding comes out as 0 or one whole step: it
# is held to delta plus one step of its own binade, and its difference is
# printed; every other logit is held to delta.  A
# softcap moves no logit further (its slope is at most 1), so the greedy
# token can differ only where the plain run's top two (capped) logits are
# within 2 * delta: while a request's inputs are equal on both paths, every
# token whose plain margin exceeds 2 * delta must be equal; so the first
# token that differs must come at a step under it, and the tokens after it
# are counted, not gated.  gemma2's cap of 30 rounds every logit above ~270
# (about 4 sigma) to 30.0f, so nearly every greedy token is a tie broken by
# index and its margin is 0: there the pre-cap logits carry the check.
LM_LOGIT_ULPS = 4
# The reduced models in float32 on the card against the port's CPU run, over
# this many tokens (past gemma2-27b-reduced's window of 16), without a cache
# and through float32 caches (a bfloat16 cache can round a float32 key that
# differs in its last bit to another value; tests/test_torch_gemma2.py).
LM_F32_STEPS = 24
# The reduced model in float32 on the card against the port's CPU run: the
# CPU tests' tolerance for the float32 variants (tests/torch_lm_cases.py).
LM_F32_TOL = (1e-5, 1e-5)
# A MoE's choice of experts is a step function of its input: a one-ulp
# difference in the attention's output can flip a near-tied top-k choice,
# after which that request's logits move by far more than delta.  The kernel
# path is held to the plain path up to each request's first step whose
# experts differ, and that first flip must be a near tie on the plain path:
# its k-th and (k+1)-th router probabilities within this (the CPU tests'
# FLIP_MARGIN, tests/torch_lm_cases.py).
FLIP_MARGIN = 0.01
# Training (phase 19).  (a) The flash backward (through the kernel's autograd
# Function) against autograd through the plain version on the same inputs
# and output gradient: (B, H, Sq, Skv, D, causal, window, softcap, q scale),
# each in float32 and bfloat16 -- causal and full at (2, 8, 1024, 1024, 128),
# gemma2's options (window 256 with the softcap, and the softcap alone, q
# scaled as phase 3's so that the cap bites), D = 64, a ragged S = 1000 --
# and FLASH_BWD_CASES_BF16 in bfloat16 alone: the tensor-core kernels' one
# zero-filled 64-column box at D = 32 and D = 16.
FLASH_BWD_CASES = [
    (2, 8, 1024, 1024, 128, True, 0, 0.0, 1.0),
    (2, 8, 1024, 1024, 128, False, 0, 0.0, 1.0),
    (2, 8, 1024, 1024, 128, True, 256, GEMMA2_SOFTCAP, FLASH_CAP_Q_SCALE),
    (2, 8, 1024, 1024, 128, True, 0, GEMMA2_SOFTCAP, FLASH_CAP_Q_SCALE),
    (2, 8, 1024, 1024, 64, True, 0, 0.0, 1.0),
    (2, 8, 1000, 1000, 128, True, 0, 0.0, 1.0),
]
FLASH_BWD_CASES_BF16 = [
    (2, 8, 1024, 1024, 32, True, 0, 0.0, 1.0),
    (2, 8, 1024, 1024, 16, True, 0, 0.0, 1.0),
]
# The tolerance of each gradient (dq, dk, dv), elementwise: float32 within
# FLASH_BWD_TOL_F32 of the gradient's largest magnitude (float32 sums of up
# to 1024 products in another order: up to 2.3e-6 of it seen at 300
# positions); bfloat16 within FLASH_BWD_ULPS bfloat16 steps of that
# magnitude's binade (both sides round float32 sums to bfloat16 once, and the
# kernel's Delta = rowsum(dO * O) reads the bfloat16 output where autograd's
# softmax gradient sums P dP in float32: up to 1.8 steps seen).
FLASH_BWD_TOL_F32 = 2.0 ** -16
FLASH_BWD_ULPS = 4
# (b) The backward at the full-width training phase's shape: a microbatch of
# 2 sequences of 4096, yi-9b's 32 query heads of 128 after the GQA
# expansion, bfloat16, causal.  Its bound counts the five products (S, dP,
# dV, dK, dQ) as FLASH_BWD_FACTOR times the forward's 4 D flops a visible
# pair, at the tensor cores' rate; its bytes read q, k, v, the output, its
# gradient and the log-sum-exp once and write dq, dk, dv once.
FLASH_BWD_TRAIN = (2, 32, 4096, 4096, 128)
FLASH_BWD_FACTOR = 2.5
# (c) The reduced models' loss and gradients in float32 on the card (flash
# forward and backward kernels) against the port's CPU run of the same
# weights and batch: the loss within rtol 1e-5, each gradient within
# TRAIN_GRAD_TOL of its largest magnitude (the CPU tests hold the port to
# jax.value_and_grad within 1e-5 of it; the card's float32 flash kernels and
# cuBLAS sum in other orders again).
TRAIN_GRAD_ARCHS = ("yi-9b", "gemma2-27b")
TRAIN_GRAD_TOL = 1e-4
# (d) yi-9b at full widths (d_model 4096, 32 heads over 4 KV heads, d_ff
# 11008, vocab 64000) cut to its first TRAIN_LAYERS of 48 layers: the whole
# model's bf16 weights and gradients, float32 m, v and accumulator (16 bytes
# a parameter, ~145 GB) exceed the card; the cut's 1.94e9 parameters take ~31
# GB.  bf16 weights, the reference's default AdamW (float32 moments), a
# global batch of TRAIN_BATCH TokenPipeline sequences of train_4k's 4096 in
# TRAIN_MICROBATCHES microbatches, TRAIN_STEPS Trainer steps, a checkpoint
# every TRAIN_CKPT_EVERY (the latest kept), and one SimulatedNodeFailure
# before step TRAIN_FAIL_AT's batch: the run restores that step's last
# checkpoint and runs the step from TRAIN_FAIL_AT - 1 again, whose loss must
# repeat bit for bit.
TRAIN_ARCH = "yi-9b"
TRAIN_LAYERS = 8
TRAIN_BATCH = 4
TRAIN_SEQ = 4096
TRAIN_MICROBATCHES = 2
TRAIN_STEPS = 6
TRAIN_CKPT_EVERY = 2
TRAIN_FAIL_AT = 3
# The case of each kernel that the summary's JSON line shows, and the only one
# whose plain version phase 3 times (the stereo kernels' elas-kitti frame; the
# backward's is phase 19's training shape).
SHOWN = {"flash_attention": f"yi-9b decode bfloat16 Skv={FLASH_DECODE[-1][3]}"}
# The mesh phase (20): yi-9b's serving wave under the mesh, phase 11's first
# wave with each prompt cut to its first MESH_PROMPT tokens, runs MESH_NEW new
# tokens (each decode step dispatches every operation through DTensor).
MESH_PROMPT = 4
MESH_NEW = 4
# The dry-run phase (21): cells traced over the fake (16, 16) cuda mesh.  A
# train_4k cell traces 16 microbatches of 48 layers' forward, recompute and
# backward through DTensor: several minutes on the host, so the phase takes
# the prefill cell beside decode (PERF.md).
DRYRUN_CELLS = (("yi-9b", "decode_32k"), ("yi-9b", "prefill_32k"))
DRYRUN_PEAK_GIB = 80
# The examples phase (22): each of examples/torch_*.py through its main() on
# the card, at the reference's defaults, and besides: torch_train_lm.py at its
# 100m preset (12 x 768, 12 heads over 4 KV heads, D = 64, vocab 32768) for
# EXAMPLE_TRAIN_STEPS steps, and torch_stereo_serving.py at KITTI's frame size
# with EXAMPLE_KITTI_STREAMS streams of as many frames.
EXAMPLE_TRAIN_STEPS = 30
EXAMPLE_KITTI_STREAMS = 4


def main() -> int:
    # torch.compile (phase 3's flex_attention yardstick) compiles in this
    # process and caches under build/, not in the user's home or temp dir.
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch

    t_start = time.perf_counter()

    def phase_starts(n) -> None:
        print(f"phase {n} starts {time.perf_counter() - t_start:.1f} s into the run", flush=True)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.elas_stereo import KITTI, SYNTH, TSUKUBA
    from repro_torch.core import pipeline
    from repro_torch.core.dense import candidate_bitmask_rows, candidate_set
    from repro_torch.core.descriptor import extract_views
    from repro_torch.core.postprocess import gap_interpolation, lr_consistency
    from repro_torch.core.support import candidate_rows
    from repro_torch.core.tiling import TileSpec
    from repro_torch.data.stereo import synthetic_stereo_pair, synthetic_stereo_sequence
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import dense_match as dense_kernel
    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import median as median_kernel
    from repro_torch.kernels import sobel as sobel_kernel
    from repro_torch.kernels import support_match as support_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # (name, module, counter attribute, source, the TPU kernel it replaces)
    kernels = [
        ("support_match", support_kernel, "launches",
         "src/repro_torch/kernels/csrc/support_match.cu",
         "src/repro/kernels/support_match.py:79"),
        ("dense_match_stream", dense_kernel, "launches",
         "src/repro_torch/kernels/csrc/dense_match_stream.cu",
         "src/repro/kernels/dense_match.py:190"),
        ("dense_match_windowed", dense_kernel, "windowed_launches",
         "src/repro_torch/kernels/csrc/dense_match_windowed.cu",
         "src/repro/kernels/dense_match.py:88"),
        ("sobel", sobel_kernel, "launches",
         "src/repro_torch/kernels/csrc/sobel.cu", "src/repro/kernels/sobel.py:32"),
        ("median3x3", median_kernel, "launches",
         "src/repro_torch/kernels/csrc/median.cu", "src/repro/kernels/median.py:18"),
        # The reference's warm scan is XLA (core/dense.py:250
        # dense_match_warm_xla), whose tile body is this oracle.
        ("dense_match_warm", dense_kernel, "warm_launches",
         "src/repro_torch/kernels/csrc/dense_match_warm.cu",
         "src/repro/kernels/ref.py:827"),
        ("flash_attention", flash_kernel, "launches",
         "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:108"),
        # No Pallas kernel has a backward: the reference trains attention
        # through XLA's autodiff of blockwise_attention.
        ("flash_attention_bwd", flash_kernel, "backward_launches",
         "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "src/repro/models/attention.py:172"),
    ]

    def reset_counts():
        for _, module, attr, _, _ in kernels:
            setattr(module, attr, 0)

    def read_counts() -> dict:
        return {name: getattr(module, attr) for name, module, attr, _, _ in kernels}

    # ---- 1. device -------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} (count {count})")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    card = f"[{smi}]"

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {len(logs)} of {len(_build.sources())} kernels compiled in "
          f"{time.perf_counter() - t0:.2f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")
    # The bfloat16 flash paths, forward and backward, must reach the tensor
    # cores: Hopper's warpgroup MMA shows in the SASS as HGMMA.
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    for lib in ("flash_attention", "flash_attention_bwd"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(lib))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        hgmma = sum("HGMMA" in line for line in sass.splitlines())
        print(f"{lib} SASS: {hgmma} HGMMA instructions")
        if not hgmma:
            raise AssertionError(f"the {lib} library holds no HGMMA: bf16 misses the tensor cores")

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_rows(prof) -> list:
        """(self device us, count, name) of the device-side rows of a trace
        (kernels, copies, sets).  The host ops that launch them carry the same
        device time again, so only these rows are summed."""
        return [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]

    def traced_rows(fn, reps: int, what: str) -> list:
        """The device rows of a trace of ``reps`` calls of ``fn``.  A trace
        that caught no device activity at all (CUPTI now and then hands back
        none: a trace of a few long flash launches came back empty five
        times in a row once) is taken again, up to twenty times; then the
        run fails."""
        for _ in range(20):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            traced = device_rows(prof)
            if traced:
                return traced
            print(f"the trace of {what} caught no device activity; taken again")
        raise AssertionError(f"twenty traces of {what} caught no device activity")

    def kernel_ms(fn, kernel: str, reps: int) -> tuple[float, float]:
        """(the kernel's own device time per launch from the profiler, the
        wrapper's time per call by CUDA events over back-to-back calls).  The
        second includes the wrapper's host work, which is longer than a small
        kernel.  ``kernel`` is part of the kernel's symbol; a trace with no
        device row of that name fails the run."""
        per_call = cuda_ms(fn, reps)
        traced = traced_rows(fn, reps, kernel)
        rows = [r for r in traced if kernel in r[2]]
        launched = sum(r[1] for r in rows)
        if not launched:
            names = sorted({r[2][:80] for r in traced})
            raise AssertionError(f"the profiler shows no device row named {kernel!r} "
                                 f"(device rows: {names})")
        return sum(r[0] for r in rows) / launched / 1e3, per_call

    def traced_ms(fn, reps: int, what: str) -> tuple[float, float]:
        """(the device time of one call of ``fn``: every device row of a trace
        of ``reps`` calls, summed, over ``reps``; the time per call by CUDA
        events over back-to-back calls, host work included), for the plain
        stereo versions, whose thousands of launches a call keep the host
        behind the device.  A trace can lose records (up to a few in 10^3
        in these traces of 10^4-10^5 operations, and more in short traces),
        so two traces are taken and count only when their device operations
        agree to within one in a hundred; the fuller one gives the time.
        Taken again up to five times, then the run fails."""
        per_call = cuda_ms(fn, reps)
        for _ in range(5):
            rows = [traced_rows(fn, reps, what) for _ in range(2)]
            ops = [sum(r[1] for r in t) for t in rows]
            if abs(ops[0] - ops[1]) <= max(ops) // 100:
                full = rows[ops.index(max(ops))]
                return sum(r[0] for r in full) / reps / 1e3, per_call
            print(f"two traces of {reps} calls of {what} hold {ops} device operations; "
                  f"taken again")
        raise AssertionError(f"five pairs of traces of {what} disagree")

    def queued_ms(fn, reps: int, what: str) -> tuple[float, float]:
        """(the device time of one call of ``fn``, by CUDA events around
        ``reps`` calls queued behind a spin kernel, so that the device runs
        them back to back with no host gap; the time per call by CUDA events
        over back-to-back calls, host work included), for functions of a few
        launches a call (SDPA, the plain flash, Sobel and median versions).
        It counts only when the spin is still running after the host has
        queued the last call; the spin is made 4x longer up to three times,
        then the run fails."""
        per_call = cuda_ms(fn, reps)
        spin_ms = 2 * per_call * reps + 1.0
        for _ in range(4):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(spin_ms * 2e6))       # cycles: ~2 GHz, so >= spin_ms
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            ahead = not start.query()
            torch.cuda.synchronize()
            if ahead:
                return start.elapsed_time(end) / reps, per_call
            spin_ms *= 4
        raise AssertionError(f"the host never got ahead of the device on {what}")

    def bound(nbytes: int, ops: int) -> tuple[float, str]:
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def nbytes_of(*tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)

    def mismatches(got, want) -> tuple[int, float]:
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        mism = sum(int((g != x).sum()) for g, x in zip(got, want))
        err = max(float((g.float() - x.float()).abs().max()) for g, x in zip(got, want))
        return mism, err

    def pair(cfg, d_max: float, seed: int = 0):
        return synthetic_stereo_pair(height=cfg.height, width=cfg.width, d_max=d_max,
                                     seed=seed)

    results = {}

    def record(kernel, label, err, ms, plain, b_ms, b_by, library=None):
        results[(kernel, label)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                        bound_ms=b_ms, bound_by=b_by, library_ms=library)

    # Phase 3 checks every case against the plain version, but times the
    # plain version only in the case the summary's line shows (SHOWN);
    # dense_profile.py --plain and flash_profile.py --plain time it at every
    # other shape.
    def plain_timed(kernel, label, timer, fn, reps, what):
        """(device ms, ms a call) of the plain version by ``timer``, or
        (None, None) where this case's is not timed here."""
        if label != SHOWN.get(kernel, "elas-kitti"):
            return None, None
        return timer(fn, reps, what)

    def plain_text(plain, plain_call, script) -> str:
        if plain is None:
            return f"plain not timed here ({script} --plain)"
        return f"plain {plain:.4f} ms device ({plain_call:.4f} ms a call)"

    # ---- 3. kernels against their plain versions ----------------------------
    phase_starts(3)
    # The dense energy's exp and log: the card's sequence against the plain
    # helpers over the energy's input ranges (x <= 0 for exp; every float32
    # in [3, 4) = [gamma, gamma + 1) for log).
    gen = torch.Generator().manual_seed(0)
    x = (-88.5 * torch.rand(1 << 22, generator=gen)).to(dev)
    y = torch.arange(0x40400000, 0x40800000, dtype=torch.int32, device=dev).view(torch.float32)
    ex, _ = dense_kernel.xla_exp_log(x)
    _, lg = dense_kernel.xla_exp_log(y)
    m_exp = int((ex.view(torch.int32) != ref.xla_exp_f32(x).view(torch.int32)).sum())
    m_log = int((lg.view(torch.int32) != ref.xla_log_f32(y).view(torch.int32)).sum())
    print(f"xla exp/log: exp mismatches {m_exp} of {x.numel()} (x in [-88.5, 0]), log "
          f"mismatches {m_log} of {y.numel()} (every float32 in [3, 4)) {card}")
    if m_exp or m_log:
        raise AssertionError("the card's exp/log differ from the plain helpers")
    # The warm kernel's fast reciprocal (rcp.approx and a Newton step), which
    # it uses only where every candidate's q lies in [1, 2^126): against a
    # division on every float32 there, in chunks of 2^26.
    m_rcp, first, last = 0, 0x3F800000, 0x7E800000
    for lo in range(first, last, 1 << 26):
        q = torch.arange(lo, min(lo + (1 << 26), last), dtype=torch.int32,
                         device=dev).view(torch.float32)
        want = torch.div(torch.ones_like(q), q)
        m_rcp += int((dense_kernel.warm_reciprocal(q).view(torch.int32)
                      != want.view(torch.int32)).sum())
    del q, want
    print(f"warm reciprocal: mismatches {m_rcp} of {last - first} against a division (every "
          f"float32 in [1, 2^126)) {card}")
    if m_rcp:
        raise AssertionError("the warm kernel's reciprocal differs from a division")

    def support_maps(cfg, d_max, seed=0):
        """Both views' descriptor maps of one pair, ([B,] H, W, 16)."""
        il, ir, _ = pair(cfg, d_max, seed)
        return extract_views(torch.as_tensor(il, device=dev), torch.as_tensor(ir, device=dev))

    def support_rows(maps, p):
        """The candidate rows as the path passes them: strided views of the
        descriptor maps."""
        return [candidate_rows(m, p.candidate_step) for m in maps]

    def support_kw(p):
        return dict(num_disp=p.num_disp, step=p.candidate_step, offset=p.candidate_step // 2,
                    support_texture=p.support_texture, support_ratio=p.support_ratio,
                    lr_threshold=p.lr_threshold, disp_min=p.disp_min)

    def check_support(label, cfg, d_max):
        p = cfg.params
        rows_l, rows_r = support_rows(support_maps(cfg, d_max), p)
        kw = support_kw(p)
        got = support_kernel.support_match(rows_l, rows_r, **kw)
        want = ref.support_match_rows_streaming(rows_l, rows_r, **kw)
        torch.cuda.synchronize()
        mism, err = mismatches(got, want)
        gh, w, _ = rows_l.shape
        gw = w // p.candidate_step
        us = torch.arange(gw) * p.candidate_step + p.candidate_step // 2
        pairs = gh * (sum(min(p.num_disp, w - u) for u in range(w))
                      + int(torch.clamp(us + 1, max=p.num_disp).sum()))
        nbytes = 2 * rows_l.numel() + 4 * gh * gw
        b_ms, b_by = bound(nbytes, pairs * (OPS_SAD + OPS_INSERT4))
        ms, call = kernel_ms(lambda: support_kernel.support_match(rows_l, rows_r, **kw),
                             "support_match_kernel", 50)
        plain, plain_call = plain_timed(
            "support_match", label, traced_ms,
            lambda: ref.support_match_rows_streaming(rows_l, rows_r, **kw), 1, "plain support")
        print(f"kernel support_match {label} rows {tuple(rows_l.shape)} D={p.num_disp}: "
              f"mismatches {mism} of {got.numel()}, max_abs_err {err}, kernel {ms:.4f} ms "
              f"(per call {call:.4f} ms), {plain_text(plain, plain_call, 'dense_profile.py')}, "
              f"bound {b_ms:.5f} ms ({b_by}; {nbytes} B, "
              f"{pairs} (column, d) pairs) {card}")
        if mism:
            raise AssertionError(f"support kernel disagrees with its plain version ({label})")
        record("support_match", label, err, ms, plain, b_ms, b_by)

    def flat(t: torch.Tensor) -> torch.Tensor:
        """A wave tensor (B, rows, ...) as the plain versions take it:
        (B * rows, ...), as each wrapper's CPU branch reshapes it."""
        return t.reshape(-1, *t.shape[2:])

    def check_support_batched(label, cfg, d_max):
        """A wave of four different pairs in one launch, against the plain
        version on the same stacked rows and slot by slot against a
        per-frame launch."""
        p = cfg.params
        kw = support_kw(p)
        maps = [support_maps(cfg, d_max, seed) for seed in range(WAVE)]
        frames = [support_rows(m, p) for m in maps]
        rows_l, rows_r = support_rows([torch.stack(v) for v in zip(*maps)], p)
        got = support_kernel.support_match(rows_l, rows_r, **kw)
        want = ref.support_match_rows_streaming(flat(rows_l), flat(rows_r), **kw)
        per_frame = torch.stack([support_kernel.support_match(*f, **kw) for f in frames])
        torch.cuda.synchronize()
        mism, err = mismatches(got, want.reshape(got.shape))
        slot, _ = mismatches(got, per_frame)
        ms, _ = kernel_ms(lambda: support_kernel.support_match(rows_l, rows_r, **kw),
                          "support_match_kernel", 20)
        # The four per-frame launches in one trace: WAVE x their mean.
        per = WAVE * kernel_ms(lambda: [support_kernel.support_match(*f, **kw) for f in frames],
                               "support_match_kernel", 20)[0]
        print(f"kernel support_match {label} batched B={WAVE} {tuple(rows_l.shape)}: "
              f"mismatches {mism} of {got.numel()} against the plain version (max_abs_err "
              f"{err}), {slot} against per-frame launches; one launch {ms:.4f} ms, {WAVE} "
              f"per-frame launches {per:.4f} ms (device time) {card}")
        if mism or slot:
            raise AssertionError(f"batched support kernel disagrees ({label})")

    def dense_inputs(cfg, d_max, p, seed=0):
        """The dense stage's inputs for one frame, from the port's stages on
        the card: descriptors, priors, bitmasks and candidate tensors."""
        il, ir, _ = pair(cfg, d_max, seed)
        dl, dr, sup = pipeline.ielas_support_stage(
            torch.as_tensor(il, device=dev), torch.as_tensor(ir, device=dev), p)
        sup = pipeline.ielas_interpolate_stage(sup, p)
        mu_l, mu_r, gv_l, gv_r = pipeline._dense_priors(sup, cfg.height, cfg.width, p)
        return dict(
            dl=dl, dr=dr, mu_l=mu_l, mu_r=mu_r,
            gm_l=candidate_bitmask_rows(gv_l, p, cfg.height),
            gm_r=candidate_bitmask_rows(gv_r, p, cfg.height),
            cand_l=candidate_set(mu_l, gv_l, p), cand_r=candidate_set(mu_r, gv_r, p),
        )

    def stream_args(inp):
        return [inp[k] for k in ("dl", "dr", "mu_l", "mu_r", "gm_l", "gm_r")]

    def windowed_args(inp):
        return [inp[k] for k in ("dl", "dr", "mu_l", "mu_r", "cand_l", "cand_r")]

    def stream_kw(p):
        return dict(num_disp=p.num_disp, disp_min=p.disp_min, plane_radius=p.plane_radius,
                    cell_px=p.grid_size, beta=p.beta, gamma=p.gamma, sigma=p.sigma,
                    match_texture=p.match_texture)

    def windowed_kw(p):
        return dict(num_disp=p.num_disp, disp_min=p.disp_min, beta=p.beta, gamma=p.gamma,
                    sigma=p.sigma, match_texture=p.match_texture)

    def stream_candidates(inp, p) -> int:
        """(pixel, d, view) triples whose candidate mask holds and whose
        matching column is inside the image: the work this data needs."""
        mu_l = inp["mu_l"]
        h, w = mu_l.shape
        cw = inp["gm_l"].shape[1]
        cx = (torch.arange(w, device=dev) // p.grid_size).clamp(max=cw - 1)
        d = torch.arange(p.num_disp, device=dev, dtype=torch.float32) + p.disp_min
        u = torch.arange(w, device=dev)[:, None]
        total = 0
        for mu, gm, inside in ((mu_l, inp["gm_l"], u >= d), (inp["mu_r"], inp["gm_r"],
                                                             u + d < w)):
            r = torch.round(mu)[..., None]
            lo = (r - p.plane_radius).clamp(p.disp_min, p.disp_min + p.num_disp - 1)
            hi = (r + p.plane_radius).clamp(p.disp_min, p.disp_min + p.num_disp - 1)
            mask = gm[:, cx, :] | ((d >= lo) & (d <= hi))
            total += int((mask & inside[None]).sum())
        return total

    def windowed_inside(inp) -> tuple[int, int]:
        """(candidate slots whose matching column is inside the image, the
        distinct values among them, counted per pixel and view)."""
        w = inp["mu_l"].shape[-1]
        u = torch.arange(w, device=dev)[:, None]
        slots = distinct = 0
        for cand, sign in ((inp["cand_l"], -1), (inp["cand_r"], 1)):
            vals = cand.sort(dim=-1).values
            col = u + sign * vals
            inside = (col >= 0) & (col < w)
            first = torch.ones_like(inside)
            first[..., 1:] = vals[..., 1:] != vals[..., :-1]
            slots += int(inside.sum())
            distinct += int((inside & first).sum())
        return slots, distinct

    def check_stream(label, inp, p, time_it=True):
        args, kw = stream_args(inp), stream_kw(p)
        got = dense_kernel.dense_match_stream(*args, **kw)
        want = ref.dense_match_rows_stream_ref(*args, **kw)
        torch.cuda.synchronize()
        mism, err = mismatches(got, want)
        h, w = inp["mu_l"].shape
        line = (f"kernel dense_match_stream {label} {(h, w)} D={p.num_disp} "
                f"disp_min={p.disp_min}: mismatches {mism} of {2 * h * w}, max_abs_err {err}")
        if time_it:
            cands = stream_candidates(inp, p)
            nbytes = nbytes_of(*args) + 2 * 4 * h * w
            b_ms, b_by = bound(nbytes, cands * (OPS_SAD + OPS_ENERGY))
            old_ms, old_by = bound(nbytes, cands * (OPS_SAD + OPS_ENERGY)
                                   + 2 * h * w * p.num_disp * OPS_MASK)
            ms, call = kernel_ms(lambda: dense_kernel.dense_match_stream(*args, **kw),
                                 "dense_match_stream_kernel", 20)
            plain, plain_call = plain_timed(
                "dense_match_stream", label, traced_ms,
                lambda: ref.dense_match_rows_stream_ref(*args, **kw), 1, "plain stream dense")
            line += (f", kernel {ms:.4f} ms (per call {call:.4f} ms), "
                     f"{plain_text(plain, plain_call, 'dense_profile.py')}, "
                     f"bound {b_ms:.5f} ms ({b_by}; {nbytes} B, {cands} candidates of "
                     f"{2 * h * w * p.num_disp}; the scan's bound, a mask test per "
                     f"(pixel, d, view), {old_ms:.5f} ms, {old_by})")
            record("dense_match_stream", label, err, ms, plain, b_ms, b_by)
        print(f"{line} {card}")
        if mism:
            raise AssertionError(f"stream kernel disagrees with its plain version ({label})")

    def check_windowed(label, inp, p, time_it=True):
        args, kw = windowed_args(inp), windowed_kw(p)
        got = dense_kernel.dense_match_candidates(*args, **kw)
        want = ref.dense_match_rows_windowed_ref(*args, **kw)
        torch.cuda.synchronize()
        mism, err = mismatches(got, want)
        h, w = inp["mu_l"].shape
        c = inp["cand_l"].shape[-1]
        line = (f"kernel dense_match_windowed {label} {(h, w)} C={c} D={p.num_disp} "
                f"disp_min={p.disp_min}: mismatches {mism} of {2 * h * w}, max_abs_err {err}")
        if time_it:
            inside, distinct = windowed_inside(inp)
            nbytes = nbytes_of(*args) + 2 * 4 * h * w
            b_ms, b_by = bound(nbytes, distinct * (OPS_SAD + OPS_ENERGY))
            old_ms, old_by = bound(nbytes, inside * (OPS_SAD + OPS_ENERGY)
                                   + 2 * h * w * c * OPS_SLOT)
            ms, call = kernel_ms(lambda: dense_kernel.dense_match_candidates(*args, **kw),
                                 "dense_match_windowed_kernel", 20)
            plain, plain_call = plain_timed(
                "dense_match_windowed", label, traced_ms,
                lambda: ref.dense_match_rows_windowed_ref(*args, **kw), 1, "plain windowed dense")
            line += (f", kernel {ms:.4f} ms (per call {call:.4f} ms), "
                     f"{plain_text(plain, plain_call, 'dense_profile.py')}, "
                     f"bound {b_ms:.5f} ms ({b_by}; {nbytes} B, {distinct} distinct in-image "
                     f"values in {inside} in-image slots of {2 * h * w * c}; the slots' "
                     f"bound, an energy per in-image slot, {old_ms:.5f} ms, {old_by})")
            record("dense_match_windowed", label, err, ms, plain, b_ms, b_by)
        print(f"{line} {card}")
        if mism:
            raise AssertionError(f"windowed kernel disagrees with its plain version ({label})")

    def check_dense_batched(kernel, label, frames, p):
        """One launch over a wave of four different frames, against the
        plain version on the same stacked inputs and slot by slot against
        a per-frame launch."""
        fn, plain, args_of, kw, symbol = {
            "dense_match_stream": (dense_kernel.dense_match_stream,
                                   ref.dense_match_rows_stream_ref, stream_args, stream_kw(p),
                                   "dense_match_stream_kernel"),
            "dense_match_windowed": (dense_kernel.dense_match_candidates,
                                     ref.dense_match_rows_windowed_ref, windowed_args,
                                     windowed_kw(p), "dense_match_windowed_kernel"),
        }[kernel]
        args = [torch.stack(x) for x in zip(*(args_of(f) for f in frames))]
        got = fn(*args, **kw)
        want = [o.reshape(got[0].shape) for o in plain(*(flat(a) for a in args), **kw)]
        per_frame = [torch.stack(x) for x in zip(*(fn(*args_of(f), **kw) for f in frames))]
        torch.cuda.synchronize()
        mism, err = mismatches(got, want)
        slot, _ = mismatches(got, per_frame)
        ms, _ = kernel_ms(lambda: fn(*args, **kw), symbol, 10)
        per = WAVE * kernel_ms(lambda: [fn(*args_of(f), **kw) for f in frames], symbol, 10)[0]
        print(f"kernel {kernel} {label} batched B={WAVE} {tuple(args[2].shape)}: mismatches "
              f"{mism} of {2 * args[2].numel()} against the plain version (max_abs_err {err}), "
              f"{slot} against per-frame launches; one launch {ms:.4f} ms, {WAVE} per-frame "
              f"launches {per:.4f} ms (device time) {card}")
        if mism or slot:
            raise AssertionError(f"batched {kernel} kernel disagrees ({label})")

    def view_stack(cfg, d_max, seeds) -> torch.Tensor:
        """(2, [B,] H, W) uint8: both views of one pair, or of a wave, as
        ``extract_views`` hands them to the Sobel kernel."""
        pairs = [pair(cfg, d_max, seed) for seed in seeds]
        views = [torch.as_tensor(np.stack([pr[i] for pr in pairs]), device=dev)
                 for i in (0, 1)]
        stack = torch.stack(views)
        return stack[:, 0] if len(seeds) == 1 else stack

    def check_sobel(label, imgs):
        got = sobel_kernel.sobel(imgs)
        want = ref.sobel_rows_ref(*ref.edge_row_views(imgs.to(torch.int32)))
        torch.cuda.synchronize()
        mism, err = mismatches(got, want)
        n = imgs.numel()
        nbytes = n * imgs.element_size() + 2 * n
        b_ms, b_by = bound(nbytes, n * OPS_SOBEL)
        ms, call = kernel_ms(lambda: sobel_kernel.sobel(imgs), "sobel_kernel", 50)
        plain, plain_call = plain_timed(
            "sobel", label, queued_ms,
            lambda: ref.sobel_rows_ref(*ref.edge_row_views(imgs.to(torch.int32))), 10,
            "plain sobel")
        print(f"kernel sobel {label} both views {tuple(imgs.shape)} {imgs.dtype}: mismatches "
              f"{mism} of {2 * n}, max_abs_err {err}, kernel {ms:.4f} ms (per call {call:.4f} ms, "
              f"the wrapper's host work included), "
              f"{plain_text(plain, plain_call, 'dense_profile.py')}, bound {b_ms:.5f} ms ({b_by}; "
              f"{nbytes} B, "
              f"{imgs.dtype} in, int8 out) {card}")
        if mism:
            raise AssertionError(f"sobel kernel disagrees with its plain version ({label})")
        record("sobel", label, err, ms, plain, b_ms, b_by)

    def median_input(args, p) -> torch.Tensor:
        """The map the median sees on the path, ([B,] H, W): the L/R-checked,
        gap-filled disparities, invalid pixels included."""
        disp_l, disp_r = dense_kernel.dense_match_stream(*args, **stream_kw(p))
        return gap_interpolation(lr_consistency(disp_l, disp_r, p), p)

    def check_median(label, d):
        got = median_kernel.median3x3(d)
        want = ref.median3x3_rows_ref(*ref.edge_row_views(d))
        torch.cuda.synchronize()
        mism, err = mismatches(got, want)
        n = d.numel()
        invalid = int((d == -1.0).sum())
        nbytes = 8 * n
        b_ms, b_by = bound(nbytes, n * OPS_MEDIAN)
        ms, call = kernel_ms(lambda: median_kernel.median3x3(d), "median3x3_kernel", 50)
        plain, plain_call = plain_timed(
            "median3x3", label, queued_ms,
            lambda: ref.median3x3_rows_ref(*ref.edge_row_views(d)), 10, "plain median")
        print(f"kernel median3x3 {label} {tuple(d.shape)} ({invalid} invalid pixels): "
              f"mismatches {mism} of {n}, max_abs_err {err}, kernel {ms:.4f} ms (per call "
              f"{call:.4f} ms), {plain_text(plain, plain_call, 'dense_profile.py')}, bound "
              f"{b_ms:.5f} ms ({b_by}; {nbytes} B) {card}")
        if mism or invalid == 0:
            raise AssertionError(f"median kernel disagrees, or no invalid pixel ({label})")
        record("median3x3", label, err, ms, plain, b_ms, b_by)

    for cfg, d_max in ((KITTI, 100.0), (TSUKUBA, 48.0)):
        check_support(cfg.name, cfg, d_max)
        check_support_batched(cfg.name, cfg, d_max)
    for cfg, d_max in ((KITTI, 100.0), (TSUKUBA, 48.0)):
        p = cfg.params
        # The wave of phase 5: seeds 0-3; seed 0 is also the single frame.
        wave = [dense_inputs(cfg, d_max, p, seed) for seed in range(WAVE)]
        check_stream(cfg.name, wave[0], p)
        check_windowed(cfg.name, wave[0], p)
        check_sobel(cfg.name, view_stack(cfg, d_max, [0]))
        check_median(cfg.name, median_input(stream_args(wave[0]), p))
        for kernel in ("dense_match_stream", "dense_match_windowed"):
            check_dense_batched(kernel, cfg.name, wave, p)
        check_sobel(f"{cfg.name} wave", view_stack(cfg, d_max, range(WAVE)))
        stacked = [torch.stack(x) for x in zip(*(stream_args(f) for f in wave))]
        check_median(f"{cfg.name} wave", median_input(stacked, p))
        del wave, stacked
    p4 = dataclasses.replace(KITTI.params, disp_min=4)
    inp = dense_inputs(KITTI, 100.0, p4)
    check_stream("elas-kitti", inp, p4, time_it=False)
    check_windowed("elas-kitti", inp, p4, time_it=False)
    del inp

    # The dense kernels' edge cases (tests/torch_kernel_cases.py, numpy only):
    # bitmask words that D ends inside, widths around the stream kernel's
    # tile, windows with values outside the search range or of one value,
    # two staging passes, ties between d = mu -/+ k.
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_kernel_cases as cases

    for kernel, table, make, fn, plain in (
        ("dense_match_stream", cases.DENSE_CASES, cases.dense_inputs,
         dense_kernel.dense_match_stream, ref.dense_match_rows_stream_ref),
        ("dense_match_windowed", cases.WINDOWED_CASES, cases.windowed_inputs,
         dense_kernel.dense_match_candidates, ref.dense_match_rows_windowed_ref),
    ):
        failed, pixels = [], 0
        for case in table:
            dl_, dr_, mu_, extra, kw = make(case)
            args = [torch.as_tensor(a, device=dev)
                    for a in (dl_, dr_, mu_[0], mu_[1], extra[0], extra[1])]
            # sigma = 1: the kernels multiply by 1 / (2 sigma^2), exactly;
            # sigma = 1.5: they divide by 2 sigma^2.
            for sigma in (kw["sigma"], 1.5):
                got = fn(*args, **{**kw, "sigma": sigma})
                mism, _ = mismatches(got, plain(*args, **{**kw, "sigma": sigma}))
                pixels += 2 * mu_[0].size
                if mism:
                    failed.append(f"{case[0]} sigma {sigma}: {mism}")
        print(f"kernel {kernel} on the {len(table)} cases of tests/torch_kernel_cases.py, "
              f"sigma 1 and 1.5: mismatches {failed or 0} of {pixels} {card}")
        if failed:
            raise AssertionError(f"{kernel} disagrees with its plain version on {failed}")

    # The support kernel's cases (widths one past a span, D ending inside a
    # d chunk, ties across chunks, KITTI and Tsukuba rows at 8 blocks a row,
    # the narrow ones at 1, and rows too wide for one block at 2, 4 and 8),
    # and the Sobel kernel's (uint8, int32, float32 with negative fractions;
    # widths 1 to 200) with each stack's first byte at offsets 0 to 15 from
    # a 16-byte boundary (as a wave's slices lie).
    failed, cells = [], 0
    support_cases = cases.SUPPORT_CASES + cases.SUPPORT_WIDE_CASES
    for case in support_cases:
        dl_, dr_, kw = cases.support_inputs(case)
        tl, tr = torch.as_tensor(dl_, device=dev), torch.as_tensor(dr_, device=dev)
        want = ref.support_match_rows_streaming(tl, tr, **kw)
        mism, _ = mismatches(support_kernel.support_match(tl, tr, **kw), want)
        cells += want.numel()
        if mism:
            failed.append(f"{case[0]}: {mism}")
    print(f"kernel support_match on the {len(support_cases)} cases of "
          f"tests/torch_kernel_cases.py: mismatches {failed or 0} of {cells} {card}")
    if failed:
        raise AssertionError(f"support kernel disagrees with its plain version on {failed}")
    failed, pixels = [], 0
    for case in cases.SOBEL_CASES:
        img = np.stack([cases.sobel_image(case), cases.sobel_image(case)[::-1].copy()])
        for offset in range(0, 16, img.itemsize):
            raw = torch.empty(img.nbytes + offset, dtype=torch.uint8, device=dev)
            view = raw[offset:].view(torch.from_numpy(img).dtype).view(img.shape)
            view.copy_(torch.as_tensor(img))
            mism, _ = mismatches(sobel_kernel.sobel(view),
                                 ref.sobel_rows_ref(*ref.edge_row_views(view.to(torch.int32))))
            pixels += 2 * img.size
            if mism:
                failed.append(f"{case[0]} offset {offset}: {mism}")
    print(f"kernel sobel on the {len(cases.SOBEL_CASES)} cases of tests/torch_kernel_cases.py, "
          f"two images a stack at byte offsets 0-15: mismatches {failed or 0} of {pixels} {card}")
    if failed:
        raise AssertionError(f"sobel kernel disagrees with its plain version on {failed}")

    failed, pixels = [], 0
    for case in cases.MEDIAN_CASES:
        stack = torch.as_tensor(cases.median_stack(case))
        for offset in range(4):
            raw = torch.empty(stack.numel() + offset, device=dev)
            view = raw[offset:].view(stack.shape)
            view.copy_(stack)
            mism, _ = mismatches(median_kernel.median3x3(view),
                                 ref.median3x3_rows_ref(*ref.edge_row_views(view)))
            pixels += stack.numel()
            if mism:
                failed.append(f"{case[0]} offset {offset}: {mism}")
    print(f"kernel median3x3 on the {len(cases.MEDIAN_CASES)} cases of "
          f"tests/torch_kernel_cases.py, two maps a stack at float offsets 0-3: mismatches "
          f"{failed or 0} of {pixels} {card}")
    if failed:
        raise AssertionError(f"median kernel disagrees with its plain version on {failed}")

    # ---- the warm band kernel ----
    def warm_kw(p, band):
        return dict(num_disp=p.num_disp, disp_min=p.disp_min, warm_band=band, beta=p.beta,
                    sigma=p.sigma, match_texture=p.match_texture)

    def warm_plain(args, kw):
        """The plain version on ([B,] H, W) inputs, as the wrapper's CPU
        branch reshapes them."""
        dl, dr, mu_l, mu_r = args
        w = mu_l.shape[-1]
        out = ref.dense_match_rows_warm_ref(dl.reshape(-1, w, 16), dr.reshape(-1, w, 16),
                                            mu_l.reshape(-1, w), mu_r.reshape(-1, w), **kw)
        return tuple(o.reshape(mu_l.shape) for o in out)

    def warm_inputs(cfg, d_max, prev=None):
        """The warm kernel's inputs for frames 1-4 of a pan, each seeded by the
        card's cold output of the frame before (or by ``prev``): descriptors
        (4, H, W, 16) and priors (4, H, W)."""
        p = cfg.params
        seq = synthetic_stereo_sequence(WAVE + 1, height=cfg.height, width=cfg.width,
                                        d_max=d_max, motion=2, seed=0)
        if prev is None:
            prev = torch.stack([pipeline.ielas_disparity(il, ir, p) for il, ir, _ in seq[:WAVE]])
        left = torch.as_tensor(np.stack([f[0] for f in seq[1:]]), device=dev)
        right = torch.as_tensor(np.stack([f[1] for f in seq[1:]]), device=dev)
        dl, dr = pipeline.ielas_descriptor_stage_batched(left, right)
        mu_l, mu_r = pipeline._warm_priors(prev, cfg.height, cfg.width, p)
        return [dl, dr, mu_l, mu_r]

    def check_warm(label, args, p, band, time_it=False):
        kw = warm_kw(p, band)
        got = dense_kernel.dense_match_warm(*args, **kw)
        want = warm_plain(args, kw)
        torch.cuda.synchronize()
        mism, err = mismatches(got, want)
        n = args[2].numel()
        # Right pixel u at d and left pixel u + d at d need the same SAD:
        # `shared` of the `right` right-view candidates are left-view ones too.
        left, right, shared = ref.warm_band_counts(args[2], args[3], num_disp=p.num_disp,
                                                   disp_min=p.disp_min, warm_band=band)
        line = (f"kernel dense_match_warm {label} {tuple(args[2].shape)} D={p.num_disp} band "
                f"{band}: mismatches {mism} of {2 * n}, max_abs_err {err}; {shared} of {right} "
                f"right-view candidates ({shared / max(right, 1):.4f}) share the left view's SAD")
        if time_it:
            cands = left + right
            nbytes = nbytes_of(*args) + 2 * 4 * n
            b_ms, b_by = bound(nbytes, (cands - shared) * OPS_SAD + cands * OPS_WARM_ENERGY)
            old_ms, old_by = bound(nbytes, cands * (OPS_SAD + OPS_WARM_ENERGY))
            ms, call = kernel_ms(lambda: dense_kernel.dense_match_warm(*args, **kw),
                                 "dense_match_warm_kernel", 20)
            plain, plain_call = plain_timed("dense_match_warm", label, traced_ms,
                                            lambda: warm_plain(args, kw), 1, "plain warm dense")
            line += (f", kernel {ms:.4f} ms (per call {call:.4f} ms), "
                     f"{plain_text(plain, plain_call, 'dense_profile.py')}, "
                     f"bound {b_ms:.5f} ms ({b_by}; {nbytes} B, {cands} in-image band "
                     f"candidates of {2 * n * p.num_disp} (pixel, d, view), {cands - shared} "
                     f"distinct SADs; a SAD per candidate: {old_ms:.5f} ms, {old_by})")
            record("dense_match_warm", label, err, ms, plain, b_ms, b_by)
        print(f"{line} {card}")
        if mism:
            raise AssertionError(f"warm kernel disagrees with its plain version ({label})")

    for cfg, d_max in ((KITTI, 100.0), (TSUKUBA, 48.0)):
        p = cfg.params
        wave_args = warm_inputs(cfg, d_max)
        frame = [a[0] for a in wave_args]
        check_warm(cfg.name, frame, p, WARM_BAND, time_it=True)
        check_warm(f"{cfg.name} band 0", frame, p, 0)
        check_warm(f"{cfg.name} band 2 (band_radius 2 under warm_band 8)", frame, p, 2)
        for shift, end in ((-300.0, "low"), (300.0, "high")):
            shifted = frame[:2] + [frame[2] + shift, frame[3] + shift]
            check_warm(f"{cfg.name} bands at the range's {end} end", shifted, p, WARM_BAND)
        invalid = warm_inputs(cfg, d_max, prev=torch.full((WAVE, cfg.height, cfg.width), -1.0,
                                                          device=dev))
        check_warm(f"{cfg.name} all-invalid prior", [a[0] for a in invalid], p, WARM_BAND)
        check_warm(f"{cfg.name} batched B={WAVE}", wave_args, p, WARM_BAND)
        kw = warm_kw(p, WARM_BAND)
        got = dense_kernel.dense_match_warm(*wave_args, **kw)
        per_frame = [dense_kernel.dense_match_warm(*(a[i] for a in wave_args), **kw)
                     for i in range(WAVE)]
        slot, _ = mismatches(got, [torch.stack(x) for x in zip(*per_frame)])
        ms, _ = kernel_ms(lambda: dense_kernel.dense_match_warm(*wave_args, **kw),
                          "dense_match_warm_kernel", 10)
        per = WAVE * kernel_ms(lambda: [dense_kernel.dense_match_warm(*(a[i] for a in wave_args),
                                                                      **kw)
                                        for i in range(WAVE)], "dense_match_warm_kernel", 10)[0]
        print(f"kernel dense_match_warm {cfg.name} batched B={WAVE}: mismatches {slot} against "
              f"per-frame launches; one launch {ms:.4f} ms, {WAVE} per-frame launches "
              f"{per:.4f} ms (device time) {card}")
        if slot:
            raise AssertionError(f"batched warm kernel disagrees with per-frame launches "
                                 f"({cfg.name})")
        del wave_args, frame, invalid, got, per_frame
    failed, pixels = [], 0
    for case in cases.WARM_CASES:
        dl_, dr_, mu_, kw = cases.warm_inputs(case)
        args = [torch.as_tensor(a, device=dev) for a in (dl_, dr_, mu_[0], mu_[1])]
        for sigma in (kw["sigma"], 1.5):
            mism, _ = mismatches(dense_kernel.dense_match_warm(*args, **{**kw, "sigma": sigma}),
                                 warm_plain(args, {**kw, "sigma": sigma}))
            pixels += 2 * mu_[0].size
            if mism:
                failed.append(f"{case[0]} sigma {sigma}: {mism}")
    print(f"kernel dense_match_warm on the {len(cases.WARM_CASES)} cases of "
          f"tests/torch_kernel_cases.py, sigma 1 and 1.5: mismatches {failed or 0} of {pixels} "
          f"{card}")
    if failed:
        raise AssertionError(f"warm kernel disagrees with its plain version on {failed}")

    import torch.nn.functional as F

    def flash_inputs(dtype) -> list:
        gen = torch.Generator().manual_seed(0)
        return [torch.randn(FLASH_SHAPE, generator=gen).to(dev, dtype) for _ in range(3)]

    def check_flash(dtype, causal) -> torch.Tensor:
        """The kernel against its plain version at FLASH_SHAPE, with
        scaled_dot_product_attention's time on the same inputs beside it."""
        q, k, v = flash_inputs(dtype)
        dname = str(dtype).removeprefix("torch.")
        label = f"qwen2.5-32b {dname} {'causal' if causal else 'full'}"
        got = flash_kernel.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        atol, rtol = FLASH_TOL[dname]
        over = int((diff > atol + rtol * want.float().abs()).sum())
        err = float(diff.max())
        del diff
        b, h, s, d = FLASH_SHAPE
        ops = 4 * b * h * s * s * d // (2 if causal else 1)
        nbytes = nbytes_of(q, k, v, got)
        t_ops = ops / FLASH_PEAK_FLOPS[dname] * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        symbol = "flash_attention_bf16_kernel" if dtype == torch.bfloat16 else \
            "flash_attention_f32_kernel"
        ms, call = kernel_ms(lambda: flash_kernel.flash_attention(q, k, v, causal=causal),
                             symbol, 5)
        plain, plain_call = plain_timed(
            "flash_attention", label, traced_ms,
            lambda: ref.flash_attention_ref(q, k, v, causal=causal), 2, "plain flash")
        library, library_call = queued_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), 10, "SDPA")
        # A yardstick, not a gate: how far SDPA's own output lies from the plain
        # version, under the tolerance the kernel is held to.
        sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=causal).float()
        want = want.float()
        sdpa_over = int(((sdpa - want).abs() > atol + rtol * want.abs()).sum())
        del want, sdpa
        print(f"kernel flash_attention {label} {FLASH_SHAPE}: {over} of {got.numel()} outside "
              f"atol {atol} + rtol {rtol} x |plain|, max_abs_err {err}, kernel {ms:.4f} ms "
              f"(per call {call:.4f} ms), {plain_text(plain, plain_call, 'flash_profile.py')}, "
              f"scaled_dot_product_attention {library:.4f} ms device ({library_call:.4f} "
              f"ms a call; {sdpa_over} of {got.numel()} outside the same tolerance), "
              f"bound {b_ms:.5f} ms ({b_by}; {nbytes} B, {ops} flops at "
              f"{FLASH_PEAK_FLOPS[dname] / 1e12:g} TFLOP/s) {card}")
        if over:
            raise AssertionError(f"flash kernel outside its tolerance of the plain version "
                                 f"({label})")
        record("flash_attention", label, err, ms, plain, b_ms, b_by, library)
        return got

    flash_out = {(dtype, causal): check_flash(dtype, causal)
                 for dtype in (torch.float32, torch.bfloat16) for causal in (True, False)}

    def visible_pairs(sq, skv, causal, window) -> int:
        """(query, key) pairs a head computes: row i sees min(i + 1, window)
        keys when causal (Sq <= Skv), all Skv otherwise."""
        if not causal:
            return sq * skv
        return int(np.minimum(np.arange(1, sq + 1), window or sq).sum())

    def check_flash_lm(shape, causal, arch="yi-9b", kv_heads=LM_KV_HEADS, timed=None):
        """The kernel against its plain version at an LM serving shape of
        ``arch``, in bfloat16; ``timed`` (by default at the decode shapes of
        FLASH_DECODE_TIMED) also timed, with the kernel's bound over the
        visible pairs, the path's byte bound (``kv_heads`` read once) and
        scaled_dot_product_attention's device time."""
        b, h, sq, skv, d = shape
        gen = torch.Generator().manual_seed(1)
        q, k, v = (torch.randn((b, h, n, d), generator=gen).to(dev, torch.bfloat16)
                   for n in (sq, skv, skv))
        label = f"{arch} {'prefill' if causal else 'decode'} bfloat16 Skv={skv}"
        got = flash_kernel.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal).float()
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        atol, rtol = FLASH_TOL["bfloat16"]
        over = int((diff > atol + rtol * want.abs()).sum())
        err = float(diff.max())
        line = (f"kernel flash_attention {label} {shape}: {over} of {got.numel()} outside atol "
                f"{atol} + rtol {rtol} x |plain|, max_abs_err {err}")
        if shape in FLASH_DECODE_TIMED if timed is None else timed:
            nbytes = nbytes_of(q, k, v, got)
            # the path's attention: q, out, and the keys and values of kv_heads heads
            gqa_bytes = nbytes_of(q, got) + 2 * b * kv_heads * skv * d * k.element_size()
            ops = 4 * b * h * visible_pairs(sq, skv, causal, 0) * d
            t_ops = ops / FLASH_PEAK_FLOPS["bfloat16"] * 1e3
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            gqa_ms = max(gqa_bytes / PEAK_BYTES_PER_S * 1e3, t_ops)
            ms, call = kernel_ms(lambda: flash_kernel.flash_attention(q, k, v, causal=causal),
                                 "flash_attention_bf16_kernel", 200)
            plain, plain_call = plain_timed(
                "flash_attention", label, traced_ms,
                lambda: ref.flash_attention_ref(q, k, v, causal=causal), 5, "plain flash")
            library, library_call = queued_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), 200, "SDPA")
            sdpa_rows = traced_rows(
                lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), 10, "SDPA")
            line += (f", kernel {ms:.4f} ms (per call {call:.4f} ms), "
                     f"{plain_text(plain, plain_call, 'flash_profile.py')}, "
                     f"scaled_dot_product_attention "
                     f"{library:.4f} ms device ({library_call:.4f} ms a call; kernels "
                     f"{sorted({r[2][:60] for r in sdpa_rows})}), bound {b_ms:.6f} ms ({b_by}; "
                     f"{nbytes} B, {ops} flops); the path's bound with {kv_heads} KV heads "
                     f"read once {gqa_ms:.6f} ms ({gqa_bytes} B), the kernel at "
                     f"{ms / gqa_ms:.1f}x it")
            record("flash_attention", label, err, ms, plain, b_ms, b_by, library)
        print(f"{line} {card}")
        if over:
            raise AssertionError(f"flash kernel outside its tolerance of the plain version "
                                 f"({label})")

    for shape in (*FLASH_DECODE, FLASH_DECODE_LONG):
        check_flash_lm(shape, causal=False)
    check_flash_lm(FLASH_PREFILL, causal=True)
    check_flash_lm(FLASH_JAMBA_DECODE, causal=False, arch="jamba-1.5-large-398b",
                   kv_heads=JAMBA_KV_HEADS)
    # the stub-frontend backbones: 28 query heads (qwen2-vl), head width 64 (musicgen)
    for arch, kv_heads, prefill, decode in FLASH_FRONTEND:
        check_flash_lm(prefill, causal=True, arch=arch, kv_heads=kv_heads, timed=True)
        check_flash_lm(decode, causal=False, arch=arch, kv_heads=kv_heads, timed=True)

    def flex_yardstick(q, k, v, causal, window, softcap, want, atol, rtol):
        """torch.nn.attention.flex_attention, compiled, with the softcap as a
        score_mod and the causal window as a block mask: one PyTorch call of
        the same function, timed beside the kernel as a yardstick only (the
        port never calls it).  Returns (its device ms a call, its outputs
        outside the tolerance, a note); (None, None, the error's first line)
        where it does not compile or run."""
        try:
            from torch.nn.attention.flex_attention import create_block_mask, flex_attention

            def score_mod(score, b, h, qi, ki):
                return softcap * torch.tanh(score / softcap)

            def mask_mod(b, h, qi, ki):
                ok = ki <= qi
                return ok & (qi - ki < window) if window else ok

            mask = (create_block_mask(mask_mod, None, None, q.shape[2], k.shape[2], device=dev)
                    if causal else None)
            fn = torch.compile(flex_attention)
            t0 = time.perf_counter()
            out = fn(q, k, v, score_mod=score_mod, block_mask=mask).float()
            torch.cuda.synchronize()
            note = f"compiled and run in {time.perf_counter() - t0:.1f} s"
        except Exception as e:                          # a yardstick: reported, not a phase
            first = (str(e).strip().splitlines() or [repr(e)])[0]
            return None, None, f"flex_attention failed: {type(e).__name__}: {first[:200]}"
        outside = int(((out - want).abs() > atol + rtol * want.abs()).sum())
        del out
        ms, _ = queued_ms(lambda: fn(q, k, v, score_mod=score_mod, block_mask=mask), 10,
                          "flex_attention")
        return ms, outside, note

    def check_flash_gemma2(shape, causal, window, label):
        """The kernel with gemma2's softcap (and window) against its plain
        version in bfloat16, q scaled so that the cap bites; timed, with the
        bound over the visible pairs, the plain version's and flex_attention's
        device time.  Decode also prints the path's byte bound with gemma2's
        16 KV heads read once."""
        b, h, sq, skv, d = shape
        gen = torch.Generator().manual_seed(2)
        q, k, v = (torch.randn((b, h, n, d), generator=gen).mul_(s).to(dev, torch.bfloat16)
                   for n, s in ((sq, FLASH_CAP_Q_SCALE), (skv, 1.0), (skv, 1.0)))
        opts = dict(causal=causal, window=window, softcap=GEMMA2_SOFTCAP)
        got = flash_kernel.flash_attention(q, k, v, **opts)
        want = ref.flash_attention_ref(q, k, v, **opts).float()
        torch.cuda.synchronize()
        atol, rtol = FLASH_TOL["bfloat16"]
        diff = (got.float() - want).abs()
        over = int((diff > atol + rtol * want.abs()).sum())
        err = float(diff.max())
        del diff
        scores = float((q[0, 0, -256:].float() @ k[0, 0].float().T).abs().max()) / d ** 0.5
        pairs = visible_pairs(sq, skv, causal, window)
        ops = 4 * b * h * pairs * d
        nbytes = nbytes_of(q, k, v, got)
        t_ops = ops / FLASH_PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        reps = 200 if sq == 1 else 5
        ms, call = kernel_ms(lambda: flash_kernel.flash_attention(q, k, v, **opts),
                             "flash_attention_bf16_kernel", reps)
        plain, plain_call = plain_timed(
            "flash_attention", label, traced_ms, lambda: ref.flash_attention_ref(q, k, v, **opts),
            5 if sq == 1 else 1, "plain flash")
        library, lib_over, note = flex_yardstick(q, k, v, causal, window, GEMMA2_SOFTCAP, want,
                                                 atol, rtol)
        line = (f"kernel flash_attention {label} {shape} causal={causal} window={window} "
                f"softcap={GEMMA2_SOFTCAP} (|scaled score| up to {scores:.1f}): {over} of "
                f"{got.numel()} outside atol {atol} + rtol {rtol} x |plain|, max_abs_err {err}, "
                f"kernel {ms:.4f} ms (per call {call:.4f} ms), "
                f"{plain_text(plain, plain_call, 'flash_profile.py')}, flex_attention "
                + (f"{library:.4f} ms device ({lib_over} of {got.numel()} outside the same "
                   f"tolerance; {note})" if library is not None else f"not measured ({note})")
                + f", bound {b_ms:.6f} ms ({b_by}; {pairs} visible pairs a head, {ops} flops, "
                f"{nbytes} B)")
        if sq == 1:
            gqa_bytes = nbytes_of(q, got) + 2 * b * GEMMA2_KV_HEADS * skv * d * k.element_size()
            gqa_ms = max(gqa_bytes / PEAK_BYTES_PER_S * 1e3, t_ops)
            line += (f"; the path's bound with {GEMMA2_KV_HEADS} KV heads read once "
                     f"{gqa_ms:.6f} ms ({gqa_bytes} B), the kernel at {ms / gqa_ms:.1f}x it")
        print(f"{line} {card}")
        if over:
            raise AssertionError(f"flash kernel outside its tolerance of the plain version "
                                 f"({label})")
        record("flash_attention", label, err, ms, plain, b_ms, b_by, library)
        del q, k, v, got, want
        torch.cuda.empty_cache()

    check_flash_gemma2(FLASH_GEMMA2_DECODE, False, 0,
                       f"gemma2-27b decode bfloat16 Skv={FLASH_GEMMA2_DECODE[3]}")
    check_flash_gemma2(FLASH_GEMMA2_PREFILL, True, GEMMA2_WINDOW,
                       f"gemma2-27b local bfloat16 S={FLASH_GEMMA2_PREFILL[2]}")
    check_flash_gemma2(FLASH_GEMMA2_PREFILL, True, 0,
                       f"gemma2-27b global bfloat16 S={FLASH_GEMMA2_PREFILL[2]}")

    # The options' edge cases, both dtypes, against the plain version.
    edge_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        atol, rtol = FLASH_TOL[dname]
        for window, softcap in FLASH_GEMMA2_EDGES:
            gen = torch.Generator().manual_seed(3)
            s_ = FLASH_GEMMA2_EDGE_S
            q, k, v = (torch.randn((1, 4, s_, 128), generator=gen).to(dev, dtype)
                       for _ in range(3))
            if softcap:
                q *= FLASH_CAP_Q_SCALE
            opts = dict(causal=True, window=window, softcap=softcap)
            got = flash_kernel.flash_attention(q, k, v, **opts).float()
            want = ref.flash_attention_ref(q, k, v, **opts).float()
            diff = (got - want).abs()
            over = int((diff > atol + rtol * want.abs()).sum())
            edge_rows.append(f"{dname} window {window} softcap {softcap}: {over} outside, max "
                             f"{float(diff.max()):.3g}")
            if over:
                raise AssertionError(f"flash kernel outside its tolerance of the plain version "
                                     f"({dname}, S={s_}, window {window}, softcap {softcap})")
    print(f"kernel flash_attention gemma2 edge cases (1, 4, {FLASH_GEMMA2_EDGE_S}, "
          f"{FLASH_GEMMA2_EDGE_S}, 128) causal, softcap rows with q x {FLASH_CAP_Q_SCALE}: "
          f"{'; '.join(edge_rows)} {card}")
    del q, k, v, got, want, diff

    # The examples' head widths, both dtypes, against the plain version.
    narrow_rows = []
    for b, h, sq, skv, d in FLASH_EXAMPLE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).removeprefix("torch.")
            atol, rtol = FLASH_TOL[dname]
            gen = torch.Generator().manual_seed(4)
            q, k, v = (torch.randn((b, h, n, d), generator=gen).to(dev, dtype)
                       for n in (sq, skv, skv))
            for causal in ((True, False) if sq == skv else (False,)):
                got = flash_kernel.flash_attention(q, k, v, causal=causal).float()
                want = ref.flash_attention_ref(q, k, v, causal=causal).float()
                diff = (got - want).abs()
                over = int((diff > atol + rtol * want.abs()).sum())
                narrow_rows.append(f"{(b, h, sq, skv, d)} {dname} causal={causal}: {over} of "
                                   f"{got.numel()} outside, max {float(diff.max()):.3g}")
                if over:
                    raise AssertionError(f"flash kernel outside its tolerance of the plain "
                                         f"version ({(b, h, sq, skv, d)}, {dname}, "
                                         f"causal={causal})")
    print(f"kernel flash_attention at the examples' head widths 32 and 16: "
          f"{'; '.join(narrow_rows)} {card}")
    del q, k, v, got, want, diff

    def trace(label, fn):
        """``fn`` once more under torch.profiler: the device's busy share of
        its wall time and the kernels that take its device time.  Returns
        the device rows and the wall time (us)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = device_rows(prof)
        busy_us = sum(r[0] for r in rows)
        if not rows:
            print(f"profile {label}: no device time in the trace (not measured) {card}")
            return rows, wall_us
        top = "; ".join(f"{k[:48]} x{n} {t:.1f} us" for t, n, k in sorted(rows, reverse=True)[:8])
        print(f"profile {label}: {wall_us:.1f} us wall under the profiler, device "
              f"busy {busy_us:.1f} us ({100 * busy_us / wall_us:.1f}%), "
              f"{sum(r[1] for r in rows)} device operations; top: {top} {card}")
        out_dir = ROOT / "build" / "traces"
        out_dir.mkdir(parents=True, exist_ok=True)
        table = "\n".join(f"{t:12.1f} us {n:6d} x  {k}" for t, n, k in sorted(rows, reverse=True))
        (out_dir / f"profile-{label.replace(' ', '-')}.txt").write_text(f"{card}\n{table}\n")
        return rows, wall_us

    def median_of(v):
        return sorted(v)[len(v) // 2]

    def check_output(label, out, cfg):
        """The range and coverage checks of tests/test_system.py."""
        p = cfg.params
        if out.shape[-2:] != (cfg.height, cfg.width) or out.dtype != torch.float32:
            raise AssertionError(f"{label}: output {tuple(out.shape)} {out.dtype}")
        valid = out != -1.0
        if not bool(torch.isfinite(out).all()) or float(valid.float().mean()) <= 0.5:
            raise AssertionError(f"{label}: non-finite output or under half the pixels valid")
        if float(out[valid].min()) < p.disp_min or float(out[valid].max()) > p.disp_max:
            raise AssertionError(f"{label}: disparities outside [disp_min, disp_max]")

    # ---- 4. single frame -------------------------------------------------
    phase_starts(4)
    launches = {k[0]: 0 for k in kernels}
    per_frame = {"support_match": 1, "dense_match_stream": 1, "dense_match_windowed": 0,
                 "sobel": 1, "median3x3": 1, "dense_match_warm": 0, "flash_attention": 0,
                 "flash_attention_bwd": 0}
    frames = 6
    single, single_bad = {}, {}
    for cfg, d_max in ((KITTI, 100.0), (TSUKUBA, 48.0)):
        p = cfg.params
        il, ir, gt = pair(cfg, d_max)
        reset_counts()
        warm = pipeline.ielas_disparity(il, ir, p)          # the entry point, on cuda:0
        torch.cuda.synchronize()
        stage_ms = {"support": [], "interpolation": [], "dense": []}
        wall = []
        for _ in range(frames - 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            t0 = time.perf_counter()
            ev[0].record()
            dl, dr, sup = pipeline.ielas_support_stage(
                torch.as_tensor(il, device=dev), torch.as_tensor(ir, device=dev), p)
            ev[1].record()
            sup = pipeline.ielas_interpolate_stage(sup, p)
            ev[2].record()
            out = pipeline.ielas_dense_stage(dl, dr, sup, p)
            ev[3].record()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            for i, key in enumerate(stage_ms):
                stage_ms[key].append(ev[i].elapsed_time(ev[i + 1]))
            if not torch.equal(out, warm):
                raise AssertionError(f"{cfg.name}: frames of one input differ")
        counts = read_counts()
        if counts != {k: frames * n for k, n in per_frame.items()}:
            raise AssertionError(f"{cfg.name}: launches {counts} for {frames} frames")
        for k in launches:
            launches[k] += counts[k]
        check_output(cfg.name, out, cfg)
        on_cpu = pipeline.ielas_disparity(il, ir, p, device="cpu")
        cpu_mism = int((out.cpu() != on_cpu).sum())
        if cpu_mism > FRAME_TOLERANCE * out.numel():
            raise AssertionError(f"{cfg.name}: card vs CPU differ in {cpu_mism} pixels")
        gt_t = torch.as_tensor(gt, device=dev)
        bad = float(pipeline.bad_pixel_rate(out, gt_t))
        err = float(pipeline.disparity_error(out, gt_t))
        med = {key: median_of(v) for key, v in stage_ms.items()}
        wall_med = median_of(wall)
        single[cfg.name] = wall_med
        single_bad[cfg.name] = bad
        print(f"e2e {cfg.name} {cfg.height}x{cfg.width} D={p.num_disp}: launches {counts} "
              f"in {frames} frames; median of {frames - 1} frames: support "
              f"{med['support']:.3f} ms, interpolation {med['interpolation']:.3f} ms, "
              f"dense {med['dense']:.3f} ms (CUDA events), frame {wall_med * 1e3:.3f} ms "
              f"wall = {1.0 / wall_med:.2f} fps; bad-pixel rate (tau 3) {bad:.4f}, "
              f"Eq.1 error {err:.4f}; card vs CPU mismatches {cpu_mism} of {out.numel()} "
              f"{card}")
        trace(f"{cfg.name} frame", lambda: pipeline.ielas_disparity(il, ir, p))

    # ---- 5. wave ---------------------------------------------------------
    phase_starts(5)
    routes = (("stream", None, "dense_match_stream"),
              ("take", TileSpec(gather="take"), "dense_match_windowed"))
    waves = 4
    bare_wave_fps = {}
    for cfg, d_max in ((KITTI, 100.0), (TSUKUBA, 48.0)):
        p = cfg.params
        pairs = [pair(cfg, d_max, seed)[:2] for seed in range(WAVE)]
        left_np = np.stack([pr[0] for pr in pairs])
        right_np = np.stack([pr[1] for pr in pairs])
        # Each pair's single-frame output on the card (stream route); phase 4
        # holds that route against the CPU.
        want = torch.stack([pipeline.ielas_disparity(il, ir, p) for il, ir in pairs])
        if len({hashlib.sha256(w.cpu().numpy().tobytes()).hexdigest() for w in want}) != WAVE:
            raise AssertionError(f"{cfg.name}: the wave's {WAVE} pairs must differ")

        for route, tile, dense_name in routes:
            def run_wave(times=None):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                t0 = time.perf_counter()
                ev[0].record()
                left = torch.as_tensor(left_np, device=dev)
                right = torch.as_tensor(right_np, device=dev)
                dl, dr, sup = pipeline.ielas_support_stage_batched(left, right, p)
                ev[1].record()
                full = torch.stack([pipeline.ielas_interpolate_stage(s, p) for s in sup])
                ev[2].record()
                out = pipeline.ielas_dense_stage_batched(dl, dr, full, p, tile=tile)
                ev[3].record()
                torch.cuda.synchronize()
                if times is not None:
                    times["wall"].append(time.perf_counter() - t0)
                    for i, key in enumerate(("support", "interpolation", "dense")):
                        times[key].append(ev[i].elapsed_time(ev[i + 1]))
                return out

            reset_counts()
            times = {"support": [], "interpolation": [], "dense": [], "wall": []}
            run_wave()
            for _ in range(waves - 1):
                out = run_wave(times)
                slot_mism = [int((out[i] != want[i]).sum()) for i in range(WAVE)]
                if any(slot_mism):
                    raise AssertionError(f"{cfg.name} {route}: wave slots differ from the "
                                         f"single-frame output: {slot_mism}")
            counts = read_counts()
            expect = {k: waves if k in ("support_match", "sobel", "median3x3", dense_name)
                      else 0 for k in launches}
            if counts != expect:
                raise AssertionError(f"{cfg.name} {route}: launches {counts} for {waves} "
                                     f"waves, expected {expect}")
            for k in launches:
                launches[k] += counts[k]
            check_output(f"{cfg.name} {route} wave", out, cfg)
            med = {key: median_of(v) for key, v in times.items()}
            if tile is None:
                bare_wave_fps[cfg.name] = WAVE / med["wall"]
            print(f"wave {cfg.name} {route} B={WAVE}: launches {counts} in {waves} waves; "
                  f"every slot equals its single-frame output; median of {waves - 1} waves: "
                  f"support {med['support']:.3f} ms, interpolation "
                  f"{med['interpolation']:.3f} ms, dense {med['dense']:.3f} ms (CUDA "
                  f"events), wave {med['wall'] * 1e3:.3f} ms wall = "
                  f"{WAVE / med['wall']:.2f} frames/s (single frame "
                  f"{1.0 / single[cfg.name]:.2f} fps) {card}")
            trace(f"{cfg.name} {route} wave of {WAVE}", run_wave)

    # ---- 6. golden frame across devices -------------------------------------
    phase_starts(6)
    il, ir, _ = synthetic_stereo_pair(height=57, width=83, d_max=24, seed=11)
    on_card = pipeline.ielas_disparity(il, ir, SYNTH.params).cpu().numpy()
    on_cpu = pipeline.ielas_disparity(il, ir, SYNTH.params, device="cpu").numpy()
    sha_card = hashlib.sha256(on_card.tobytes()).hexdigest()
    sha_cpu = hashlib.sha256(on_cpu.tobytes()).hexdigest()
    mism = int((on_card != on_cpu).sum())
    print(f"golden 57x83: card sha256 {sha_card}, cpu sha256 {sha_cpu}, pinned "
          f"{GOLDEN_SHA256}; card vs cpu mismatches {mism} of {on_cpu.size} "
          f"(tolerance {GOLDEN_TOLERANCE}) {card}")
    if sha_cpu != GOLDEN_SHA256:
        raise AssertionError("the port's CPU output left the pinned golden digest")
    if mism > GOLDEN_TOLERANCE:
        raise AssertionError(f"card output differs from the CPU output in {mism} pixels")

    # ---- 7. attention ------------------------------------------------------
    phase_starts(7)
    reset_counts()
    for (dtype, causal), want in flash_out.items():
        q, k, v = flash_inputs(dtype)
        out = flash_kernel.flash_attention(q, k, v, causal=causal)   # the entry point
        torch.cuda.synchronize()
        if out.shape != want.shape or out.dtype != dtype or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"attention {dtype} causal={causal}: output "
                                 f"{tuple(out.shape)} {out.dtype}, or not finite")
        if not torch.equal(out, want):
            raise AssertionError(f"attention {dtype} causal={causal}: differs from phase 3's")
    counts = read_counts()
    expect = {k: len(flash_out) if k == "flash_attention" else 0 for k in launches}
    if counts != expect:
        raise AssertionError(f"attention: launches {counts}, expected {expect}")
    for k in launches:
        launches[k] += counts[k]
    print(f"attention {FLASH_SHAPE} float32 and bfloat16, causal and full: launches "
          f"{counts}; every output equals phase 3's, which is held to the plain version {card}")
    del flash_out, q, k, v, out, want
    torch.cuda.empty_cache()

    # ---- 8. service --------------------------------------------------------
    phase_starts(8)
    from repro_torch.launch import serve as serve_launch
    from repro_torch.serving import FaultPlan, FaultSpec, StereoService

    wave_kernels = ("support_match", "sobel", "dense_match_stream", "median3x3")
    for cfg, d_max in ((KITTI, 100.0), (TSUKUBA, 48.0)):
        p = cfg.params
        pairs = {(s, i): pair(cfg, d_max, SERVICE_FRAMES * s + i)[:2]
                 for s in range(SERVICE_STREAMS) for i in range(SERVICE_FRAMES)}
        want = {key: pipeline.ielas_disparity(il, ir, p).cpu().numpy()
                for key, (il, ir) in pairs.items()}
        n = len(pairs)
        svc = StereoService(p, batch=WAVE, device="cuda", wave_linger=0.01)
        svc.warmup([(cfg.height, cfg.width)])
        reset_counts()

        def burst():
            """Both streams' frames submitted at once, interleaved; every
            delivery collected."""
            for i in range(SERVICE_FRAMES):
                for s in range(SERVICE_STREAMS):
                    svc.submit(i, *pairs[(s, i)], stream_id=s)
            return svc.collect(n, timeout=600, strict=True)

        with svc:
            t0 = time.perf_counter()
            done = burst()
            wall = time.perf_counter() - t0
            counts = read_counts()
            st = svc.stats()
            trace(f"{cfg.name} service burst of {n}", burst)
        for k, c in read_counts().items():
            launches[k] += c - counts[k]      # the traced burst's launches
        bad = [c.error for c in done if not c.ok]
        mism = sum(int((c.disparity != want[(c.stream_id, c.frame_id)]).sum())
                   for c in done if c.ok)
        order = {s: [c.frame_id for c in done if c.stream_id == s]
                 for s in range(SERVICE_STREAMS)}
        expect = {k: st.waves if k in wave_kernels else 0 for k in launches}
        print(f"service {cfg.name} batch {WAVE}, {SERVICE_STREAMS} streams x {SERVICE_FRAMES} "
              f"frames: {len(done)} delivered, {len(bad)} failed, mismatches {mism} against "
              f"the card's single-frame outputs; waves {st.waves}, occupancy "
              f"{st.wave_occupancy:.3f}, cache misses {st.cache_misses}, launches {counts}; "
              f"latency p50 {st.latency_p50_ms:.3f} ms, p95 {st.latency_p95_ms:.3f} ms; "
              f"{n / wall:.2f} frames/s through the service ({n} frames in {wall * 1e3:.3f} "
              f"ms, first submit to last delivery) against {bare_wave_fps[cfg.name]:.2f} "
              f"frames/s of phase 5's bare wave {card}")
        if bad or mism or len(done) != n:
            raise AssertionError(f"service {cfg.name}: failed {bad[:2]}, {mism} mismatches")
        if any(order[s] != list(range(SERVICE_FRAMES)) for s in order):
            raise AssertionError(f"service {cfg.name}: streams out of order: {order}")
        if st.cache_misses != 0:
            raise AssertionError(f"service {cfg.name}: {st.cache_misses} misses after warm-up")
        if counts != expect:
            raise AssertionError(f"service {cfg.name}: launches {counts} for {st.waves} waves")
        for k in launches:
            launches[k] += counts[k]

        # Containment on the card: wave 0's dense stage fails once (its frames
        # are retried one by one); request 5 fails on every attempt.
        poison = 5
        plan = FaultPlan([FaultSpec(stage="dense", wave=0, times=1),
                          FaultSpec(stage="dense", request_id=poison, times=None)])
        svc = StereoService(p, batch=WAVE, device="cuda", wave_linger=0.01, fault_plan=plan)
        svc.warmup([(cfg.height, cfg.width)])
        reset_counts()
        with svc:
            rids = {svc.submit(i, *pairs[(0, i)]): i for i in range(SERVICE_FRAMES)}
            done = svc.collect(SERVICE_FRAMES, timeout=600, strict=True)
        for k, c in read_counts().items():
            launches[k] += c
        st = svc.stats()
        by_rid = {c.request_id: c for c in done}
        recovered = [c for rid, c in by_rid.items() if rid != poison]
        mism = sum(int((c.disparity != want[(0, rids[rid])]).sum())
                   for rid, c in by_rid.items() if rid != poison and c.ok)
        print(f"service {cfg.name} faults: wave 0's dense stage failed once, request {poison} "
              f"on every attempt; retried {st.retried}, failed frames {st.failed_frames} "
              f"({by_rid[poison].error!r:.80}), {len(recovered)} others delivered with "
              f"{mism} mismatches {card}")
        if (plan.fired(0) != 1 or by_rid[poison].ok or st.failed_frames != 1
                or not all(c.ok for c in recovered) or mism or st.retried < 2):
            raise AssertionError(f"service {cfg.name}: fault containment failed")

    reset_counts()
    rc = serve_launch.main(["stereo", "--frames", "8", "--batch", str(WAVE), "--height", "120",
                            "--width", "160", "--device", "cuda"])
    counts = read_counts()
    print(f"serve stereo (repro_torch.launch.serve, 8 frames 120x160): exit {rc}, "
          f"launches {counts} {card}")
    if rc != 0 or any(counts[k] == 0 for k in wave_kernels):
        raise AssertionError("the serve launcher failed or launched no kernel")
    for k in launches:
        launches[k] += counts[k]

    # ---- 9. warm video -----------------------------------------------------
    phase_starts(9)
    cfg, d_max = KITTI, 100.0
    p = cfg.params
    seq = synthetic_stereo_sequence(VIDEO_FRAMES, height=cfg.height, width=cfg.width,
                                    d_max=d_max, motion=2, cut_at=VIDEO_CUT, seed=0)
    warm_counters = ("warm_frames", "cold_frames", "scene_changes", "warm_refreshes",
                     "warm_reruns", "warm_resets")

    def drive(svc):
        """One frame at a time: frame t + 1 is submitted once t is delivered."""
        outs = []
        for t, (il, ir, _) in enumerate(seq):
            svc.submit(t, il, ir)
            outs += svc.collect(1, timeout=900, strict=True)
        st = svc.stats()
        return outs, {k: getattr(st, k) for k in warm_counters}

    # Twice: at the default post-hoc bound (a warm result whose disagreement
    # with its seed exceeds 0.15 * num_disp is re-run cold), and at 0.5.
    shape = dict(warm_frames=VIDEO_FRAMES - 2, cold_frames=2, scene_changes=1,
                 warm_refreshes=0, warm_resets=0)
    cold_ids = {0, VIDEO_CUT}
    for rerun_threshold in (0.15, 0.5):
        kw = dict(batch=1, warm_start=True, rerun_threshold=rerun_threshold)
        t0 = time.perf_counter()
        with StereoService(p, device="cpu", **kw) as svc:
            cpu_outs, cpu_counts = drive(svc)
        cpu_s = time.perf_counter() - t0
        svc = StereoService(p, device="cuda", **kw)
        svc.warmup([(cfg.height, cfg.width)])
        reset_counts()
        with svc:
            outs, video_counts = drive(svc)
        counts = read_counts()
        for k in launches:
            launches[k] += counts[k]
        bad = [c.error for c in outs if not c.ok]
        if bad or len(outs) != VIDEO_FRAMES:
            raise AssertionError(f"warm video: {len(outs)} delivered, failed {bad[:2]}")
        mism = [int((c.disparity != x.disparity).sum()) for c, x in zip(outs, cpu_outs)]
        for c in outs:
            check_output(f"warm video frame {c.frame_id}", torch.as_tensor(c.disparity), cfg)
        reruns = video_counts["warm_reruns"]
        expect = {k: 0 for k in launches}
        expect.update(support_match=2 + reruns, dense_match_stream=2 + reruns,
                      sobel=VIDEO_FRAMES + reruns, median3x3=VIDEO_FRAMES + reruns,
                      dense_match_warm=VIDEO_FRAMES - 2)
        warm_lat = [round(c.latency_s * 1e3, 3) for c in outs if c.frame_id not in cold_ids]
        cold_lat = [round(c.latency_s * 1e3, 3) for c in outs if c.frame_id in cold_ids]
        print(f"warm video {cfg.name} {cfg.height}x{cfg.width}, {VIDEO_FRAMES} frames, cut at "
              f"{VIDEO_CUT}, StereoService(batch=1, warm_start=True, rerun_threshold="
              f"{rerun_threshold}): mismatches {mism} against the port's CPU service "
              f"({cpu_s:.1f} s); counters {video_counts} (CPU run {cpu_counts}; "
              f"{video_counts['warm_frames'] - reruns} warm frames delivered from the warm "
              f"scan, {reruns} re-run cold); launches {counts}; latency (submit to delivery) "
              f"warm frames {warm_lat} ms, cold frames {cold_lat} ms {card}")
        if any(mism):
            raise AssertionError(f"warm video: card vs CPU frames differ: {mism}")
        if video_counts != cpu_counts or any(video_counts[k] != v for k, v in shape.items()):
            raise AssertionError(f"warm video: counters {video_counts}, CPU {cpu_counts}, "
                                 f"expected {shape}")
        if counts != expect:
            raise AssertionError(f"warm video: launches {counts}, expected {expect}")

    # The dense stage of frame 1, warm (seeded by the delivered frame 0) and
    # cold (after the support stage), and the whole frame, on the card.
    il, ir, _ = seq[1]
    left, right = torch.as_tensor(il, device=dev), torch.as_tensor(ir, device=dev)
    prev = torch.as_tensor(outs[0].disparity, device=dev)
    dl, dr, sup = pipeline.ielas_support_stage(left, right, p)
    sup = pipeline.ielas_interpolate_stage(sup, p)
    cold_dense = cuda_ms(lambda: pipeline.ielas_dense_stage(dl, dr, sup, p), 5)
    warm_dense = cuda_ms(lambda: pipeline.ielas_warm_dense_stage(dl, dr, prev, p), 5)

    def walls(fn) -> float:
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return median_of(times) * 1e3

    def warm_frame():
        dl_, dr_ = pipeline.ielas_descriptor_stage_batched(left[None], right[None])
        return pipeline.ielas_warm_dense_stage(dl_[0], dr_[0], prev, p)

    cold_wall = walls(lambda: pipeline.ielas_disparity(il, ir, p))
    warm_wall = walls(warm_frame)
    print(f"warm video {cfg.name} frame 1: dense stage warm {warm_dense:.3f} ms vs cold "
          f"{cold_dense:.3f} ms (CUDA events, mean of 5); frame warm {warm_wall:.3f} ms "
          f"(descriptors + warm dense stage) vs cold {cold_wall:.3f} ms (ielas_disparity), "
          f"wall, median of 5 {card}")

    # ---- 10. hybrid baseline -------------------------------------------------
    phase_starts(10)
    # Original ELAS with a host-side Delaunay prior (the paper's Table IV
    # comparison) on phase 4's pairs: the support stage on the card, the
    # grid to the host and two scipy Delaunay priors, the dense half (stream
    # kernel) and post-processing (median kernel) on the card.
    for cfg, d_max in ((KITTI, 100.0), (TSUKUBA, 48.0)):
        p = cfg.params
        il, ir, gt = pair(cfg, d_max)
        reset_counts()
        first = pipeline.elas_baseline_disparity(il, ir, p)    # the entry point, on cuda:0
        torch.cuda.synchronize()
        times = {"support": [], "host": [], "back": [], "wall": []}
        for _ in range(BASELINE_FRAMES - 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            t0 = time.perf_counter()
            ev[0].record()
            dl, dr, sup = pipeline.ielas_support_stage(
                torch.as_tensor(il, device=dev), torch.as_tensor(ir, device=dev), p)
            ev[1].record()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mu_l, mu_r = pipeline._delaunay_priors(sup, cfg.height, cfg.width, p)
            t2 = time.perf_counter()
            ev[2].record()
            out = pipeline._baseline_back_half(dl, dr, sup, mu_l, mu_r, p)
            ev[3].record()
            torch.cuda.synchronize()
            times["wall"].append(time.perf_counter() - t0)
            times["host"].append((t2 - t1) * 1e3)
            times["support"].append(ev[0].elapsed_time(ev[1]))
            times["back"].append(ev[2].elapsed_time(ev[3]))
            if not torch.equal(out, first):
                raise AssertionError(f"baseline {cfg.name}: frames of one input differ")
        counts = read_counts()
        expect = {k: BASELINE_FRAMES * n for k, n in per_frame.items()}
        if counts != expect:
            raise AssertionError(f"baseline {cfg.name}: launches {counts} for {BASELINE_FRAMES} "
                                 f"frames, expected {expect}")
        for k in launches:
            launches[k] += counts[k]
        check_output(f"baseline {cfg.name}", out, cfg)
        on_cpu = pipeline.elas_baseline_disparity(il, ir, p, device="cpu")
        cpu_mism = int((out.cpu() != on_cpu).sum())
        gt_t = torch.as_tensor(gt, device=dev)
        bad = float(pipeline.bad_pixel_rate(out, gt_t))
        med = {key: median_of(v) for key, v in times.items()}
        host_share = med["host"] / (med["wall"] * 1e3)
        print(f"baseline {cfg.name} {cfg.height}x{cfg.width} (elas_baseline_disparity): "
              f"launches {counts} in {BASELINE_FRAMES} frames; median of "
              f"{BASELINE_FRAMES - 1} frames: support {med['support']:.3f} ms (CUDA events), "
              f"host {med['host']:.3f} ms (the grids' copies to the host, two "
              f"delaunay_prior calls and the priors' copies back, host clock; "
              f"{host_share:.3f} of the frame), back half {med['back']:.3f} ms (CUDA events), "
              f"frame {med['wall'] * 1e3:.3f} ms wall = {1.0 / med['wall']:.2f} fps against "
              f"ielas_disparity's {1.0 / single[cfg.name]:.2f} fps (phase 4); bad-pixel rate "
              f"(tau 3) {bad:.4f} against ielas_disparity's {single_bad[cfg.name]:.4f}; card vs "
              f"CPU mismatches {cpu_mism} of {out.numel()} {card}")
        if cpu_mism:
            raise AssertionError(f"baseline {cfg.name}: card vs CPU differ in {cpu_mism} pixels")

    # ---- 11-16. LM serving ------------------------------------------------
    # The decoders through ServeEngine.  On a GQA layer every attention is a
    # flash kernel launch (decode: one query against the cache's valid
    # prefix, or on gemma2's local layers its last 4096 positions); an MLA
    # layer's attention is plain PyTorch (the absorbed decode) and launches
    # none; the projections, the MLP and the MoE experts are torch matmuls.
    # yi-9b (phase 11), gemma2-27b (phase 12: sliding window and softcap in
    # the kernel), deepseek-v2-lite-16b (phase 13: MLA and static-capacity
    # MoE), each at full width, then deepseek-v2-236b cut to LM_CUT_LAYERS
    # layers (phase 14: q-LoRA, 160 experts), then jamba-1.5-large-398b's
    # first LM_CUT_LAYERS layers (phase 15: three Mamba layers, plain
    # PyTorch as the reference's are plain JAX, and one GQA layer on the
    # flash kernel; MoE of 16 experts on layers 1 and 3), then xlstm-350m at
    # full width (phase 16: 21 mLSTM and 3 sLSTM layers, plain PyTorch as the
    # reference's are plain JAX; no flash launch); each model is freed
    # before the next is made.
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import common as common_mod
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.models.config import LayerKind
    from repro_torch.models.model import LMModel, count_params
    from repro_torch.serving import ServeEngine, decode_step
    from repro_torch.serving import engine as engine_mod

    def serve_lm_phase(phase: int, arch: str, cut: int = 0):
        phase_starts(phase)
        cfg = get_config(arch)
        how = "no cut"
        if cut:
            # the first `cut` layers; where they end inside the repeated unit
            # (jamba's 8-layer unit), the unit is cut with them
            rem = cut - len(cfg.prefix)
            change = (dict(num_layers=cut) if rem % len(cfg.pattern_unit) == 0
                      else dict(num_layers=cut, pattern_unit=cfg.pattern_unit[:rem]))
            how = (f"cut from {cfg.num_layers}: dataclasses.replace(cfg, num_layers={cut}"
                   + (f", pattern_unit=cfg.pattern_unit[:{rem}]" if len(change) > 1 else "")
                   + "), full widths")
            cfg = dataclasses.replace(cfg, **change)
        capped = cfg.logit_softcap > 0.0
        n_attn = sum(k in attention_mod.ATTN_KINDS for k in cfg.layer_kinds)
        n_mamba = sum(k == LayerKind.MAMBA for k in cfg.layer_kinds)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = LMModel(cfg).init(0)                    # on cuda:0
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated() / 2**30
        if cfg.mamba is not None:
            m, e = cfg.mamba, cfg.moe
            shape = (f"Mamba d_inner {m.expand * cfg.d_model}, d_state {m.d_state}, d_conv "
                     f"{m.d_conv}, dt_rank {mamba_mod.dt_rank(cfg)}; {cfg.num_heads} heads "
                     f"({cfg.num_kv_heads} KV) of {cfg.head_dim} on the attention layers; "
                     f"dense MLP d_ff {cfg.d_ff} or MoE of {e.num_experts} experts of "
                     f"{e.d_expert}, top-{e.top_k}, on every other layer; "
                     f"{count_params(cfg, active_only=True)} active")
        elif LayerKind.MLSTM in cfg.layer_kinds:
            d_inner, dh = xlstm_mod.mlstm_dims(cfg)
            shape = (f"mLSTM d_inner {d_inner}, {xlstm_mod.MLSTM_HEADS} heads of {dh}, conv "
                     f"{xlstm_mod.CONV_K}, chunk {xlstm_mod.MLSTM_CHUNK}; sLSTM "
                     f"{xlstm_mod.SLSTM_HEADS} heads of {xlstm_mod.slstm_dims(cfg)[1]}, FFN "
                     f"{xlstm_mod.slstm_d_ff(cfg)}")
        elif cfg.mla is not None:
            m, e = cfg.mla, cfg.moe
            shape = (f"{cfg.num_heads} heads, MLA latent {m.kv_lora_rank} + rope "
                     f"{m.rope_head_dim}, nope {m.nope_head_dim}, v {m.v_head_dim}, q_lora "
                     f"{m.q_lora_rank}, d_ff {cfg.d_ff} (layer 0), MoE {e.num_experts} routed "
                     f"top-{e.top_k} + {e.num_shared} shared of {e.d_expert}, "
                     f"{count_params(cfg, active_only=True)} active")
        else:
            shape = (f"{cfg.num_heads} heads ({cfg.num_kv_heads} KV) of {cfg.head_dim}, d_ff "
                     f"{cfg.d_ff}, window "
                     f"{cfg.sliding_window if len(set(cfg.layer_kinds)) > 1 else 'none'}, "
                     f"softcaps {cfg.attn_softcap} / {cfg.logit_softcap}")
        print(f"lm {cfg.name} (phase {phase}): {count_params(cfg)} parameters, "
              f"{cfg.num_layers} layers {'/'.join(k.value for k in cfg.pattern_unit)} ({how}), "
              f"d_model {cfg.d_model}, {shape}, vocab {cfg.vocab_size}, {cfg.dtype}, seeded "
              f"weights made on the card in {time.perf_counter() - t0:.2f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak "
              f"{init_peak:.2f} GiB during init {card}")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, LM_PROMPT_LEN + 1))
                   for _ in range(LM_REQUESTS)]
        if cut:                                         # one wave
            prompts = prompts[:LM_BATCH]
        waves = [prompts[i:i + LM_BATCH] for i in range(0, len(prompts), LM_BATCH)]
        steps = sum(max(len(p) + LM_NEW - 1 for p in wave) for wave in waves)
        engine = ServeEngine(model, batch=LM_BATCH, max_len=LM_MAX_LEN)
        engine.generate(waves[0], 2)                    # warm-up: cuBLAS, the first launches
        torch.cuda.synchronize()

        step_events = []

        def timed_step(model, caches, tokens):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = decode_step(model, caches, tokens)
            ev[1].record()
            step_events.append(ev)
            return out

        engine_mod.decode_step = timed_step
        reset_counts()
        try:
            t0 = time.perf_counter()
            outs = engine.generate(prompts, LM_NEW)     # the entry point
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            engine_mod.decode_step = decode_step
        counts = read_counts()
        # flash: one launch per GQA layer per decode step, none on MLA layers
        expect = {k: n_attn * steps if k == "flash_attention" else 0 for k in launches}
        if counts != expect:
            raise AssertionError(f"lm {cfg.name}: launches {counts} in {steps} decode steps, "
                                 f"expected {expect}")
        for k in launches:
            launches[k] += counts[k]
        if (len(outs) != len(prompts) or any(len(o) != LM_NEW for o in outs)
                or not all(0 <= t < cfg.vocab_size for o in outs for t in o)):
            raise AssertionError(f"lm {cfg.name}: requests got {[len(o) for o in outs]} tokens, "
                                 f"or a token outside the vocabulary")
        if not cut:
            again = engine.generate(prompts, LM_NEW)
            if again != outs:
                raise AssertionError(f"lm {cfg.name}: a second generate gave other tokens")
        step_ms = [a.elapsed_time(b) for a, b in step_events]
        tokens = sum(len(o) for o in outs)
        print(f"lm serve {cfg.name} ServeEngine(batch={LM_BATCH}, max_len={LM_MAX_LEN}): "
              f"{len(prompts)} requests, {tokens} tokens in {len(waves)} waves of {steps} decode "
              f"steps, {wall:.3f} s wall = {tokens / wall:.2f} tokens/s; decode step median "
              f"{median_of(step_ms):.3f} ms, min {min(step_ms):.3f}, max {max(step_ms):.3f} "
              f"(CUDA events); flash launches {counts['flash_attention']} = {n_attn} GQA "
              f"layers x {steps} steps"
              f"{'' if cut else '; a second generate gives the same tokens'}; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")

        if cfg.moe is not None:
            # The MoE's dropped share at every decode step of the phase's waves
            # (decode_step discards it): at batch 4 a layer routes 4 tokens x
            # top_k, at most 4 to an expert, which its capacity of 4 holds.
            dropped = []

            @torch.inference_mode()
            def recording_step(model, caches, tokens):
                logits, caches, aux = model.apply(tokens, caches=caches)
                dropped.append(aux["fraction_dropped"])
                return caches, torch.argmax(logits[:, -1, :], dim=-1)

            engine_mod.decode_step = recording_step
            try:
                again = engine.generate(prompts, LM_NEW)
            finally:
                engine_mod.decode_step = decode_step
            dropped = torch.stack(dropped).cpu()
            moe_layers = sum(layer.is_moe for layer in model.layers)
            print(f"lm moe {cfg.name}: fraction_dropped summed over {moe_layers} MoE layers, "
                  f"at each of {len(dropped)} decode steps: max {float(dropped.max())}, "
                  f"capacity {moe_mod._capacity(LM_BATCH, cfg.moe)} slots an expert for "
                  f"{LM_BATCH} x top-{cfg.moe.top_k} choices; tokens "
                  f"{'equal' if again == outs else 'DIFFER'} to the timed run's {card}")
            if float(dropped.abs().max()) != 0.0 or again != outs:
                raise AssertionError(f"lm {cfg.name}: MoE dropped tokens at decode, or the "
                                     f"recording run's tokens differ")

        def mid_wave_step():
            """The caches of wave 0 after its longest prompt, then one decode
            step (profiled): the shapes of a step in the middle of a wave."""
            caches = model.init_caches(LM_BATCH, LM_MAX_LEN)
            toks = torch.zeros((LM_BATCH, 1), dtype=torch.long, device=dev)
            for _ in range(LM_PROMPT_LEN):
                caches, _ = decode_step(model, caches, toks)
            torch.cuda.synchronize()
            return lambda: decode_step(model, caches, toks)

        rows, wall_us = trace(f"lm {cfg.name} decode step", mid_wave_step())
        busy = sum(r[0] for r in rows)
        flash_us = sum(r[0] for r in rows if "flash_attention" in r[2])
        # cuBLAS's kernels: nvjet_* on this toolkit, *gemm* / *gemv* on others
        gemm_us = sum(r[0] for r in rows if any(w in r[2].lower() for w in
                                                ("nvjet", "gemm", "gemv", "xmma", "cutlass")))
        extra = ""
        if n_attn:
            # The GQA expansion of k and v for the kernel (attention._expand_kv),
            # one layer's traced alone at the step's shapes (the cache's valid
            # prefix of LM_PROMPT_LEN + 1 positions), times the GQA layers.
            n = LM_PROMPT_LEN + 1
            kv = [torch.zeros((LM_BATCH, LM_MAX_LEN, cfg.num_kv_heads, cfg.head_dim),
                              dtype=torch.bfloat16, device=dev) for _ in range(2)]

            def expand():
                return [attention_mod._expand_kv(t[:, :n], cfg.num_heads) for t in kv]

            exp_us = queued_ms(expand, 50, "the KV expansion")[0] * 1e3 * n_attn
            # a trace only loses records: the fullest of three counts the operations
            exp_rows = max((traced_rows(expand, 10, "the KV expansion") for _ in range(3)),
                           key=lambda t: sum(r[1] for r in t))
            exp_ops = sum(r[1] for r in exp_rows) // 10 * n_attn
            del kv
            extra = (f", the KV expansion for the kernel {exp_us:.1f} us "
                         f"({100 * exp_us / max(busy, 1e-9):.1f}%; {exp_ops} device operations, "
                         f"{n_attn} layers x one timed alone: "
                         f"{sorted({r[2][:40] for r in exp_rows})})")
        if n_mamba:
            # The Mamba mixers: one layer's decode step (its w_in and w_out
            # products included) traced alone at the step's shapes, on a
            # state as fresh as any (the step's work does not depend on it),
            # times the Mamba layers.
            layer = next(lay for lay in model.layers if lay.kind == LayerKind.MAMBA)
            h = torch.zeros((LM_BATCH, 1, cfg.d_model), dtype=model.dtype, device=dev)
            state = mamba_mod.init_mamba_state(cfg, LM_BATCH, dev)

            def mixer():
                return mamba_mod.mamba_block(layer.mixer, h, cfg, state)

            # 10 calls of ~50 launches: the queue behind the spin holds ~1,000
            with torch.inference_mode():
                mix_us = queued_ms(mixer, 10, "a Mamba mixer")[0] * 1e3 * n_mamba
                mix_rows = max((traced_rows(mixer, 10, "a Mamba mixer") for _ in range(3)),
                               key=lambda t: sum(r[1] for r in t))
            mix_ops = sum(r[1] for r in mix_rows) // 10 * n_mamba
            extra += (f", the Mamba mixers {mix_us:.1f} us "
                          f"({100 * mix_us / max(busy, 1e-9):.1f}%; {mix_ops} device "
                          f"operations, {n_mamba} layers x one timed alone, its w_in and w_out "
                          f"products included)")
            del h, state
        print(f"lm profile {cfg.name} decode step (batch {LM_BATCH}, cache index "
              f"{LM_PROMPT_LEN}): device busy {busy:.1f} us of {wall_us:.1f} us wall under the "
              f"profiler ({100 * busy / wall_us:.1f}%; "
              f"{100 * busy / 1e3 / median_of(step_ms):.1f}% of the median unprofiled step), "
              f"flash {flash_us:.1f} us "
              f"({100 * flash_us / max(busy, 1e-9):.1f}% of busy), matmuls {gemm_us:.1f} us "
              f"({100 * gemm_us / max(busy, 1e-9):.1f}%){extra}, "
              f"{sum(r[1] for r in rows)} device operations "
              f"({sum(r[1] for r in rows) / cfg.num_layers:.0f} a layer) {card}")

        if n_attn:
            # The kernel against its plain version on this path: wave 0 again,
            # every step's logits kept (and, with a logit softcap, the logits
            # before it; with a MoE, every layer's expert choices and the
            # margin between the k-th and (k+1)-th router probabilities),
            # once through the kernel and once with the attention's kernel
            # call swapped for the plain version (here only, not in the
            # package).
            def logged_wave():
                log, pre, routes = [], [], []
                logits_of, moe_block = model._logits, moe_mod.moe_block

                def logits_and_pre(x32):
                    if capped:
                        h = common_mod.rms_norm(x32[:, -1], model.final_norm, cfg.norm_eps,
                                                model.dtype)
                        pre.append((h @ model.embed.T).float())
                    return logits_of(x32)

                def routed(params, x, moe_cfg):
                    logits = x.reshape(-1, x.shape[-1]).float() @ params["router"]
                    p, e = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True)
                    k = moe_cfg.top_k
                    routes.append((e[:, :k].sort(-1).values, p[:, k - 1] - p[:, k]))
                    return moe_block(params, x, moe_cfg)

                @torch.inference_mode()
                def step(model, caches, tokens):
                    logits, caches, _ = model.apply(tokens, caches=caches)
                    log.append(logits[:, -1].clone())
                    return caches, torch.argmax(logits[:, -1], dim=-1)

                engine_mod.decode_step = step
                model._logits = logits_and_pre
                moe_mod.moe_block = routed
                try:
                    toks = ServeEngine(model, LM_BATCH, LM_MAX_LEN).generate(waves[0], LM_NEW)
                finally:
                    engine_mod.decode_step = decode_step
                    moe_mod.moe_block = moe_block
                    del model._logits
                if routes:                  # (steps, MoE layers, batch, k), (steps, layers, batch)
                    shape = (len(log), len(routes) // len(log), LM_BATCH)
                    routes = (torch.stack([e for e, _ in routes]).view(*shape, -1).cpu(),
                              torch.stack([m for _, m in routes]).view(shape).cpu())
                return toks, torch.stack(log), torch.stack(pre if capped else log), routes

            k_toks, k_logits, k_pre, k_routes = logged_wave()
            attention_mod.flash_attention = ref.flash_attention_ref
            try:
                p_toks, p_logits, p_pre, p_routes = logged_wave()
            finally:
                attention_mod.flash_attention = flash_kernel.flash_attention
            if k_toks != outs[:LM_BATCH]:
                raise AssertionError(f"lm {cfg.name}: the logged kernel run's tokens differ "
                                     f"from generate's")
            top = float(p_pre.topk(2, dim=-1).values[..., 1].max())
            delta = LM_LOGIT_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
            held = low = after = after_equal = 0
            first_delta = float((k_pre[0] - p_pre[0]).abs().max())
            max_delta = 0.0
            # each request's tokens in: step t reads seqs[i][t]
            seqs = [[int(x) for x in prompt] + k_toks[i] for i, prompt in enumerate(waves[0])]
            selfs = []          # (|d|, bound, |plain|) of a tied head's self-logit, each step

            def held_step(t, i) -> float:
                """The largest |kernel - plain| logit difference of step t,
                request i; with a tied head, all but the input token's own
                logit, whose difference and bound go to ``selfs``."""
                d = (k_pre[t, i] - p_pre[t, i]).abs()
                if cfg.tie_embeddings:
                    tok = seqs[i][t]
                    mag = max(abs(float(p_pre[t, i, tok])), top)
                    selfs.append((float(d[tok]), delta + 2.0 ** (math.floor(math.log2(mag)) - 7),
                                  mag))
                    d[tok] = 0.0
                return float(d.max())

            top2 = p_logits.topk(2, dim=-1).values
            margins = (top2[..., 0] - top2[..., 1]).cpu()
            # each request's first step whose experts differ on the two paths,
            # with the plain path's router margin at its first such layer
            first_flip = [(math.inf, 0.0)] * LM_BATCH
            if k_routes:
                differ = (k_routes[0] != p_routes[0]).any(-1)          # (steps, layers, batch)
                for i in range(LM_BATCH):
                    hits = differ[:, :, i].nonzero()
                    if len(hits):
                        t, layer_at = (int(v) for v in hits[0])
                        first_flip[i] = (t, float(p_routes[1][t, layer_at, i]))
            flips = []
            for i, prompt in enumerate(waves[0]):
                start = len(prompt) - 1                 # the step of the first new token
                flip_step, flip_margin = first_flip[i]
                j, diverged = 0, False
                while j < LM_NEW and start + j < flip_step:     # inputs and experts equal
                    margin = float(margins[start + j, i])
                    max_delta = max(max_delta, held_step(start + j, i))
                    if k_toks[i][j] != p_toks[i][j]:
                        if margin > 2 * delta:
                            raise AssertionError(
                                f"lm {cfg.name}: request {i} token {j}: the kernel path gives "
                                f"{k_toks[i][j]}, the plain path {p_toks[i][j]}, with plain "
                                f"top-2 margin {margin} > {2 * delta}")
                        diverged = True
                        break
                    held, low = held + (margin > 2 * delta), low + (margin <= 2 * delta)
                    j += 1
                if not diverged and flip_step < start + LM_NEW:
                    # the request's experts differ first while its inputs are equal
                    flips.append((i, flip_step, flip_margin))
                    if flip_margin >= FLIP_MARGIN:
                        raise AssertionError(
                            f"lm {cfg.name}: request {i} picks other experts at step "
                            f"{flip_step} with equal inputs, where the plain path's router "
                            f"margin is {flip_margin} >= {FLIP_MARGIN}")
                for t in range(min(start, flip_step)):  # the prompt's steps
                    max_delta = max(max_delta, held_step(t, i))
                after += LM_NEW - j
                after_equal += sum(a == b for a, b in zip(k_toks[i][j:], p_toks[i][j:]))
            what = "pre-cap logit" if capped else "logit"
            print(f"lm kernel vs plain attention {cfg.name} wave 0 ({LM_BATCH} requests x "
                  f"{LM_NEW} tokens): largest second-best {what} {top:.4g}, so delta = "
                  f"{LM_LOGIT_ULPS} bfloat16 steps of its binade = {delta:g}; first step max "
                  f"|d {what}| {first_delta:.6f}, max over steps with equal inputs "
                  f"{max_delta:.6f}"
                  + (f" (the input token's own tied {what} apart: |plain| up to "
                     f"{max(m for _, _, m in selfs):.6g}, it differs at {sum(a > 0 for a, _, _ in selfs)} "
                     f"of {len(selfs)} steps, by at most {max(a for a, _, _ in selfs):g}, "
                     f"bound delta + one step of its binade = {max(b for _, b, _ in selfs):g})"
                     if selfs else "")
                  + f"; while the inputs are equal, {held} tokens with plain top-2 "
                  f"margin > {2 * delta:g} (gated) and {low} under it all equal; from each "
                  f"request's first differing token on, {after_equal} of {after} equal (not "
                  f"gated)"
                  + (f"; routing flips with equal inputs (request, step, plain router margin "
                     f"< {FLIP_MARGIN}): {flips}, each request held up to its flip"
                     if cfg.moe is not None else "") + f" {card}")
            if max_delta > delta:
                raise AssertionError(f"lm {cfg.name}: the kernel path's {what}s differ from the "
                                     f"plain path's by {max_delta} > {delta} with equal inputs")
            over = [(a, b) for a, b, _ in selfs if a > b]
            if over:
                raise AssertionError(f"lm {cfg.name}: the input token's own tied {what} differs "
                                     f"from the plain path's beyond its bound with equal inputs "
                                     f"(|d|, bound): {over[:5]}")
            del k_logits, p_logits, k_pre, p_pre
        del model, engine
        gc.collect()
        torch.cuda.empty_cache()

        # The reduced model in float32 on the card against the port's CPU run.
        cfg32 = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
        on_cpu = LMModel(cfg32, device="cpu").init(0)
        on_card = LMModel(cfg32)
        on_card.load_state_dict(on_cpu.state_dict())
        rng = np.random.default_rng(0)
        prompts32 = [rng.integers(0, cfg32.vocab_size, size=rng.integers(4, LM_PROMPT_LEN + 1))
                     for _ in range(LM_REQUESTS)]
        toks_card = ServeEngine(on_card, LM_BATCH, LM_MAX_LEN).generate(prompts32, LM_NEW)
        toks_cpu = ServeEngine(on_cpu, LM_BATCH, LM_MAX_LEN).generate(prompts32, LM_NEW)
        batch_toks = torch.as_tensor(rng.integers(0, cfg32.vocab_size, (LM_BATCH, LM_F32_STEPS)))
        atol, rtol = LM_F32_TOL
        worst = 0.0
        with torch.inference_mode():
            caches = {d: m.init_caches(LM_BATCH, LM_F32_STEPS, torch.float32)
                      for d, m in (("card", on_card), ("cpu", on_cpu))}
            pairs = [(on_card.apply(batch_toks)[0], on_cpu.apply(batch_toks)[0])]   # no cache
            for t in range(LM_F32_STEPS):                                          # decode
                lc, caches["card"], _ = on_card.apply(batch_toks[:, t:t + 1],
                                                      caches=caches["card"])
                lh, caches["cpu"], _ = on_cpu.apply(batch_toks[:, t:t + 1],
                                                    caches=caches["cpu"])
                pairs.append((lc, lh))
        for lc, lh in pairs:
            lc = lc.cpu()
            worst = max(worst, float((lc - lh).abs().max()))
            if not torch.allclose(lc, lh, atol=atol, rtol=rtol):
                raise AssertionError(f"lm float32 {cfg32.name}: card logits outside atol {atol} "
                                     f"+ rtol {rtol} of the CPU's (max {worst})")
        print(f"lm {cfg32.name} float32: card tokens "
              f"{'equal' if toks_card == toks_cpu else 'DIFFER'} to the CPU run's "
              f"({LM_REQUESTS} requests x {LM_NEW}); logits (no cache over {LM_F32_STEPS} "
              f"tokens, and {LM_F32_STEPS} decode steps through float32 caches) max |card - CPU| "
              f"{worst:.3g} within atol {atol} + rtol {rtol} {card}")
        if toks_card != toks_cpu:
            raise AssertionError(f"lm float32 {cfg32.name}: card tokens differ from the CPU's")

        reset_counts()
        rc = serve_launch.main(["lm", "--device", "cuda", "--arch", arch])
        counts = read_counts()
        print(f"serve lm --arch {arch} (repro_torch.launch.serve, {arch}-reduced): exit {rc}, "
              f"launches {counts} {card}")
        # flash launches on the reduced model's GQA layers only
        if rc != 0 or (counts["flash_attention"] > 0) != (n_attn > 0):
            raise AssertionError(f"the lm serve launcher failed, or launched flash "
                                 f"{counts['flash_attention']} times on {n_attn} GQA layers")
        for k in launches:
            launches[k] += counts[k]

    for phase, (arch, cut) in enumerate(LM_ARCHS, start=11):
        serve_lm_phase(phase, arch, cut)
        gc.collect()
        torch.cuda.empty_cache()

    # xlstm-350m's chunked mLSTM on the card (phase 16, continued): a float32
    # copy of the model (init(0) in float32) over XLSTM_CHUNKED_S positions
    # without a state against as many decode steps through the states.
    cfg = dataclasses.replace(get_config("xlstm-350m"), dtype="float32")
    model = LMModel(cfg).init(0)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LM_BATCH, XLSTM_CHUNKED_S)),
                           device=dev)
    atol, rtol = XLSTM_CHUNKED_TOL
    with torch.inference_mode():
        whole = model.apply(toks)[0]
        caches = model.init_caches(LM_BATCH, 1, torch.float32)
        worst = 0.0
        for t in range(XLSTM_CHUNKED_S):
            step, caches, _ = model.apply(toks[:, t:t + 1], caches=caches)
            worst = max(worst, float((step[:, 0] - whole[:, t]).abs().max()))
            if not torch.allclose(step[:, 0], whole[:, t], atol=atol, rtol=rtol):
                raise AssertionError(f"xlstm-350m float32: step {t}'s logits outside atol "
                                     f"{atol} + rtol {rtol} of the chunked forward's")
    print(f"lm xlstm-350m float32 chunked forward over {XLSTM_CHUNKED_S} positions ("
          f"{XLSTM_CHUNKED_S // xlstm_mod.MLSTM_CHUNK} chunks a mLSTM layer, batch {LM_BATCH}) "
          f"against {XLSTM_CHUNKED_S} decode steps through the states: max |d logit| {worst:.3g} "
          f"(logits up to {float(whole.abs().max()):.3g}) within atol {atol} + rtol {rtol} {card}")
    del model, whole, caches
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 17-18. the stub-frontend backbones ----------------------------------
    # qwen2-vl-7b (phase 17: M-RoPE on a 16 x 16 patch grid, 28 query heads
    # over 4 KV heads) and musicgen-large (phase 18: sinusoidal positions, 32
    # heads of 64) at full width: the frontend's embeddings (seeded, unit
    # normal as the token embeddings are) prefilled into the caches through
    # LMModel.apply, then FRONTEND_NEW greedy decode steps of token ids
    # through decode_step.  The reference's `serve lm` refuses these archs,
    # so the model's own entry points drive them.
    def frontend_phase(phase: int, arch: str):
        phase_starts(phase)
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = LMModel(cfg).init(0)                    # on cuda:0
        torch.cuda.synchronize()
        grid = cfg.pos_embedding == "mrope"
        s = QWEN_VL_GRID ** 2 if grid else MUSICGEN_FRAMES
        max_len = s + FRONTEND_NEW + 1
        print(f"lm {cfg.name} (phase {phase}): {count_params(cfg)} parameters, "
              f"{cfg.num_layers} layers attn, d_model {cfg.d_model}, {cfg.num_heads} heads "
              f"({cfg.num_kv_heads} KV) of {cfg.head_dim}, d_ff {cfg.d_ff} ({cfg.mlp_act}), "
              f"{cfg.pos_embedding} positions, qkv bias {cfg.qkv_bias}, {cfg.frontend} inputs "
              f"(B={FRONTEND_BATCH}, S={s}, d_model), vocab {cfg.vocab_size}, {cfg.dtype}, seeded "
              f"weights made on the card in {time.perf_counter() - t0:.2f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated {card}")
        gen = torch.Generator(device=dev).manual_seed(0)
        embeds = torch.randn((FRONTEND_BATCH, s, cfg.d_model), generator=gen,
                             device=dev).to(model.dtype)
        positions = None
        if grid:                    # (t, h, w) = (0, row, column) of each patch
            rows, cols = np.divmod(np.arange(s), QWEN_VL_GRID)
            pos = np.stack([np.zeros_like(rows), rows, cols], -1)
            positions = torch.as_tensor(pos, device=dev).expand(FRONTEND_BATCH, s, 3)

        def prefill():
            caches = model.init_caches(FRONTEND_BATCH, max_len)
            with torch.inference_mode():
                logits, caches, _ = model.apply(embeds, positions, caches)
            return logits[:, -1].float(), caches

        # the timed run: the prefill, then the decode steps through decode_step
        prefill()
        torch.cuda.synchronize()                        # warm-up: cuBLAS, the first launches
        reset_counts()
        t0 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        last, caches = prefill()
        ev[1].record()
        tok = torch.argmax(last, -1)
        toks, step_events = [tok], []
        for _ in range(FRONTEND_NEW):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            caches, tok = decode_step(model, caches, tok[:, None])
            e[1].record()
            step_events.append(e)
            toks.append(tok)
        toks = torch.stack(toks, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        steps = FRONTEND_NEW
        expect = {k: cfg.num_layers * (1 + steps) if k == "flash_attention" else 0
                  for k in launches}
        if counts != expect:
            raise AssertionError(f"lm {cfg.name}: launches {counts} for a prefill and {steps} "
                                 f"decode steps, expected {expect}")
        for k in launches:
            launches[k] += counts[k]
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()) or \
                not bool(torch.isfinite(last).all()):
            raise AssertionError(f"lm {cfg.name}: a token outside the vocabulary, or a "
                                 f"non-finite logit")
        step_ms = [a.elapsed_time(b) for a, b in step_events]
        n_tok = FRONTEND_BATCH * (1 + steps)
        print(f"lm {cfg.name}: prefill of {FRONTEND_BATCH} x {s} embeddings "
              f"{ev[0].elapsed_time(ev[1]):.3f} ms (CUDA events), then {steps} decode steps "
              f"(decode_step): {n_tok} tokens in {wall:.3f} s wall = {n_tok / wall:.2f} "
              f"tokens/s; decode step median {median_of(step_ms):.3f} ms, min "
              f"{min(step_ms):.3f}, max {max(step_ms):.3f}; flash launches "
              f"{counts['flash_attention']} = {cfg.num_layers} layers x (1 prefill + {steps} "
              f"steps); {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")

        # one decode step in the middle, profiled
        def mid_step():
            _, caches = prefill()
            tk = toks[:, :1]
            for _ in range(FRONTEND_NEW // 2):
                caches, _ = decode_step(model, caches, tk)
            torch.cuda.synchronize()
            return lambda: decode_step(model, caches, tk)

        rows, wall_us = trace(f"lm {cfg.name} decode step", mid_step())
        busy = sum(r[0] for r in rows)
        flash_us = sum(r[0] for r in rows if "flash_attention" in r[2])
        gemm_us = sum(r[0] for r in rows if any(w in r[2].lower() for w in
                                                ("nvjet", "gemm", "gemv", "xmma", "cutlass")))
        print(f"lm profile {cfg.name} decode step (batch {FRONTEND_BATCH}, cache index "
              f"{s + FRONTEND_NEW // 2}): device busy {busy:.1f} us of {wall_us:.1f} us wall "
              f"under the profiler ({100 * busy / wall_us:.1f}%; "
              f"{100 * busy / 1e3 / median_of(step_ms):.1f}% of the median unprofiled step), "
              f"flash {flash_us:.1f} us ({100 * flash_us / max(busy, 1e-9):.1f}% of busy), "
              f"matmuls {gemm_us:.1f} us ({100 * gemm_us / max(busy, 1e-9):.1f}%), "
              f"{sum(r[1] for r in rows)} device operations "
              f"({sum(r[1] for r in rows) / cfg.num_layers:.0f} a layer) {card}")

        # The kernel against the plain-attention path: the prefill and every
        # decode step's logits, both paths fed the kernel run's tokens (so
        # their inputs are equal at every step); LM_LOGIT_ULPS as in phase 11.
        def logged(forced):
            last, caches = prefill()
            rows = [last]
            with torch.inference_mode():
                for t in range(FRONTEND_NEW):
                    logits, caches, _ = model.apply(forced[:, t:t + 1], caches=caches)
                    rows.append(logits[:, -1].float())
            return torch.stack(rows)                    # (1 + FRONTEND_NEW, B, V)

        k_logits = logged(toks)
        if not torch.equal(k_logits.argmax(-1).T, toks):
            raise AssertionError(f"lm {cfg.name}: the logged kernel run's tokens differ from "
                                 f"the timed run's")
        attention_mod.flash_attention = ref.flash_attention_ref
        try:
            p_logits = logged(toks)
        finally:
            attention_mod.flash_attention = flash_kernel.flash_attention
        top2 = p_logits.topk(2, dim=-1).values
        top = float(top2[..., 1].max())
        delta = LM_LOGIT_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
        d_max = float((k_logits - p_logits).abs().max())
        clear = (top2[..., 0] - top2[..., 1]) > 2 * delta
        held = int(clear.sum())
        differ = int((k_logits.argmax(-1) != p_logits.argmax(-1))[clear].sum())
        print(f"lm kernel vs plain attention {cfg.name} ({FRONTEND_BATCH} sequences, the "
              f"prefill and {steps} steps on the kernel run's tokens): largest second-best "
              f"logit {top:.4g}, delta = {LM_LOGIT_ULPS} bfloat16 steps of its binade = "
              f"{delta:g}; max |d logit| {d_max:.6f}; {held} of {clear.numel()} tokens with "
              f"plain top-2 margin > {2 * delta:g}, {differ} of them differ {card}")
        if d_max > delta or differ:
            raise AssertionError(f"lm {cfg.name}: the kernel path's logits differ from the "
                                 f"plain path's by {d_max} > {delta}, or {differ} tokens "
                                 f"above the margin differ")
        del model, caches, k_logits, p_logits, embeds
        gc.collect()
        torch.cuda.empty_cache()

        # The reduced model in float32 on the card against the port's CPU run:
        # its embeddings (a 4 x 4 grid for qwen2-vl) without a cache, then the
        # prefill and 8 decode steps of the CPU run's greedy tokens through
        # float32 caches.
        cfg32 = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
        on_cpu = LMModel(cfg32, device="cpu").init(0)
        on_card = LMModel(cfg32)
        on_card.load_state_dict(on_cpu.state_dict())
        s32 = 16
        x32 = torch.randn((FRONTEND_BATCH, s32, cfg32.d_model),
                          generator=torch.Generator().manual_seed(1))
        pos32 = None
        if grid:
            rows32, cols32 = np.divmod(np.arange(s32), 4)
            pos32 = torch.as_tensor(np.stack([np.zeros_like(rows32), rows32, cols32], -1))
            pos32 = pos32.expand(FRONTEND_BATCH, s32, 3)
        atol, rtol = LM_F32_TOL
        worst, equal = 0.0, True
        with torch.inference_mode():
            pairs = [(on_card.apply(x32, pos32)[0], on_cpu.apply(x32, pos32)[0])]
            caches = {d: m.init_caches(FRONTEND_BATCH, s32 + 9, torch.float32)
                      for d, m in (("card", on_card), ("cpu", on_cpu))}
            lc, caches["card"], _ = on_card.apply(x32, pos32, caches["card"])
            lh, caches["cpu"], _ = on_cpu.apply(x32, pos32, caches["cpu"])
            pairs.append((lc, lh))
            for _ in range(8):
                tok = lh[:, -1].argmax(-1)[:, None]
                equal &= torch.equal(lc[:, -1].argmax(-1).cpu(), tok[:, 0])
                lc, caches["card"], _ = on_card.apply(tok, caches=caches["card"])
                lh, caches["cpu"], _ = on_cpu.apply(tok, caches=caches["cpu"])
                pairs.append((lc, lh))
        for lc, lh in pairs:
            lc = lc.cpu()
            worst = max(worst, float((lc - lh).abs().max()))
            if not torch.allclose(lc, lh, atol=atol, rtol=rtol):
                raise AssertionError(f"lm float32 {cfg32.name}: card logits outside atol {atol} "
                                     f"+ rtol {rtol} of the CPU's (max {worst})")
        print(f"lm {cfg32.name} float32: card greedy tokens {'equal' if equal else 'DIFFER'} "
              f"to the CPU run's; logits (embeddings without a cache, and the prefill and 8 "
              f"decode steps through float32 caches) max |card - CPU| {worst:.3g} within atol "
              f"{atol} + rtol {rtol} {card}")
        if not equal:
            raise AssertionError(f"lm float32 {cfg32.name}: card tokens differ from the CPU's")

    for phase, arch in ((17, "qwen2-vl-7b"), (18, "musicgen-large")):
        frontend_phase(phase, arch)
        gc.collect()
        torch.cuda.empty_cache()

    # ---- 19. training -----------------------------------------------------
    phase_starts(19)
    import shutil

    from repro_torch.data.tokens import pipeline_for
    from repro_torch.launch import train as train_launch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.train_loop import (
        SimulatedNodeFailure, TrainConfig, Trainer, value_and_grad,
    )

    def bwd_tol(want, dtype) -> float:
        top = float(want.abs().max())
        if dtype == torch.float32:
            return FLASH_BWD_TOL_F32 * top
        return FLASH_BWD_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)

    def bwd_inputs(shape, dtype, q_scale, seed):
        b, h, sq, skv, d = shape
        gen = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn((b, h, sq, d), generator=gen, device=dev) * q_scale
        k, v = (torch.randn((b, h, skv, d), generator=gen, device=dev) for _ in range(2))
        g = torch.randn((b, h, sq, d), generator=gen, device=dev)
        return [t.to(dtype) for t in (q, k, v, g)]

    def grads_of(fn, q, k, v, g, **opts):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, **opts).backward(g)
        return [t.grad for t in leaves]

    def bits_of(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    def outside_tol(got, want, dtype) -> tuple[int, float]:
        """(outputs outside the backward's tolerance, the largest error over
        its tolerance) over the three gradients."""
        outside, worst = 0, 0.0
        for gk, gp in zip(got, want):
            gp = gp.float()
            tol = bwd_tol(gp, dtype)
            err = (gk.float() - gp).abs()
            outside += int((err > tol).sum())
            worst = max(worst, float(err.max()) / tol)
        return outside, worst

    # (a) the backward kernel against autograd through the plain version, and
    # against itself: a second call on the same inputs gives the same bits
    lines = []
    both = (torch.float32, torch.bfloat16)
    for (b, h, sq, skv, d, causal, window, cap, q_scale), dtypes in (
            [(case, both) for case in FLASH_BWD_CASES]
            + [(case, (torch.bfloat16,)) for case in FLASH_BWD_CASES_BF16]):
        for dtype in dtypes:
            q, k, v, g = bwd_inputs((b, h, sq, skv, d), dtype, q_scale, seed=sq + d)
            opts = dict(causal=causal, window=window, softcap=cap)
            before = flash_kernel.backward_launches
            got = grads_of(flash_kernel.flash_attention, q, k, v, g, **opts)
            again = grads_of(flash_kernel.flash_attention, q, k, v, g, **opts)
            torch.cuda.synchronize()
            if flash_kernel.backward_launches != before + 2:
                raise AssertionError("flash backward: the kernel path did not launch the "
                                     "backward kernel once a call")
            unequal = sum(int((bits_of(x) != bits_of(y)).sum()) for x, y in zip(got, again))
            want = grads_of(ref.flash_attention_ref, q, k, v, g, **opts)
            outside, worst = outside_tol(got, want, dtype)
            what = (f"({b}, {h}, {sq}, {skv}, {d}) {str(dtype)[6:]} "
                    f"{'causal' if causal else 'full'}"
                    + (f" window {window}" if window else "")
                    + (f" softcap {cap:g}" if cap else ""))
            lines.append(f"{what}: {outside} outside, largest error {worst:.3f} of the tolerance, "
                         f"{unequal} entries whose bits differ between two calls")
            if outside:
                raise AssertionError(f"flash backward {what}: {outside} gradient entries outside "
                                     f"the tolerance")
            if unequal:
                raise AssertionError(f"flash backward {what}: two calls on the same inputs differ "
                                     f"in {unequal} gradient entries")
    del q, k, v, g, got, again, want
    print(f"flash backward (dq, dk, dv) against autograd through the plain version, float32 "
          f"within {FLASH_BWD_TOL_F32:g} of each gradient's largest magnitude, bfloat16 within "
          f"{FLASH_BWD_ULPS} bfloat16 steps of its binade: " + "; ".join(lines) + f" {card}")

    # (b) the backward at the training shape: held to the plain version,
    # timed from the profiler rows of its three kernels, beside its bound and
    # SDPA's backward on the same tensors
    b, h, s, _, d = FLASH_BWD_TRAIN
    train_label = f"yi-9b training microbatch bfloat16 causal {FLASH_BWD_TRAIN}"
    q, k, v, g = bwd_inputs(FLASH_BWD_TRAIN, torch.bfloat16, 1.0, seed=1)
    out, lse = flash_kernel._forward(q, k, v, True, 0, 0.0, with_lse=True)

    def bwd():
        return flash_kernel.flash_attention_backward(q, k, v, out, lse, g, causal=True)

    got = bwd()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    p_out = ref.flash_attention_ref(*leaves, causal=True)

    def plain_bwd():
        return torch.autograd.grad(p_out, leaves, g, retain_graph=True)

    want = plain_bwd()
    outside, worst = outside_tol(got, want, torch.bfloat16)
    err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))
    if outside:
        raise AssertionError(f"flash backward at {FLASH_BWD_TRAIN}: {outside} gradient entries "
                             f"outside the tolerance")
    # The trace must hold each of the three kernels once a call.  A trace can
    # lose a record (one of its 15 once): it is then taken again, up to five
    # times, and a trace that lost one is never timed.
    reps = 5
    names_k = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
    for _ in range(5):
        rows = [r for r in traced_rows(bwd, reps, "the flash backward") if "flash_bwd" in r[2]]
        held = {nk: sum(r[1] for r in rows if nk in r[2]) for nk in names_k}
        if all(n == reps for n in held.values()):
            break
        print(f"the trace of {reps} backward calls holds {held} launches; taken again")
    else:
        raise AssertionError(f"five traces of {reps} backward calls lost launches of its kernels")
    parts = {nk: sum(r[0] for r in rows if nk in r[2]) / reps / 1e3 for nk in names_k}
    bwd_ms = sum(parts.values())
    plain_ms = traced_ms(plain_bwd, 2, "the plain backward")[0]
    del got, want, p_out, leaves
    torch.cuda.empty_cache()
    s_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    s_out = F.scaled_dot_product_attention(*s_leaves, is_causal=True)
    sdpa_ms = queued_ms(lambda: torch.autograd.grad(s_out, s_leaves, g, retain_graph=True), reps,
                        "SDPA's backward")[0]
    pairs = s * (s + 1) // 2
    flops = FLASH_BWD_FACTOR * 4 * b * h * pairs * d
    nbytes = nbytes_of(q, k, v, out, g, lse) + 3 * nbytes_of(q)
    t_ops = flops / FLASH_PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    record("flash_attention_bwd", train_label, err, bwd_ms, plain_ms, b_ms, b_by, sdpa_ms)
    print(f"flash backward {train_label}: {bwd_ms:.4f} ms a call on the device ("
          + ", ".join(f"{kk} {vv:.4f}" for kk, vv in parts.items())
          + f"), bound {b_ms:.4f} ms ({b_by}: {FLASH_BWD_FACTOR} x the forward's "
          f"{4 * b * h * pairs * d:.4g} causal flops at 989 TFLOP/s; {nbytes} bytes at 3.35 "
          f"TB/s {t_bytes:.4f} ms), {bwd_ms / b_ms:.1f}x the bound; plain backward (autograd "
          f"through the plain version) {plain_ms:.3f} ms; SDPA's backward {sdpa_ms:.4f} ms; "
          f"{outside} gradient entries outside the tolerance, largest error {worst:.3f} of it "
          f"{card}")
    del q, k, v, g, out, lse, s_leaves, s_out
    torch.cuda.empty_cache()

    def flash_forwards(cfg_) -> int:
        """Flash forward launches of one forward and backward: one a GQA
        layer, and one more for each GQA layer of the repeated units, whose
        forward remat runs again in the backward."""
        kinds = cfg_.layer_kinds
        n = sum(kind in attention_mod.ATTN_KINDS for kind in kinds)
        if cfg_.remat:
            n += sum(kind in attention_mod.ATTN_KINDS for kind in kinds[len(cfg_.prefix):])
        return n

    # (c) the reduced models' gradients on the card against the CPU
    for arch in TRAIN_GRAD_ARCHS:
        cfg32 = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
        on_cpu = LMModel(cfg32, device="cpu").init(0)
        on_card = LMModel(cfg32)
        on_card.load_state_dict(on_cpu.state_dict())
        batch = pipeline_for(cfg32, 2, 32, seed=5, device="cpu").batch_at(0)
        n_attn = sum(kind in attention_mod.ATTN_KINDS for kind in cfg32.layer_kinds)
        before = (flash_kernel.launches, flash_kernel.backward_launches)
        lc, _, gc_card = value_and_grad(on_card, dict(on_card.named_parameters()),
                                        {kk: vv.to(dev) for kk, vv in batch.items()})
        torch.cuda.synchronize()
        ran = (flash_kernel.launches - before[0], flash_kernel.backward_launches - before[1])
        lh, _, gc_cpu = value_and_grad(on_cpu, dict(on_cpu.named_parameters()), batch)
        if ran != (flash_forwards(cfg32), n_attn):
            raise AssertionError(f"train {cfg32.name}: flash forward / backward launches {ran}, "
                                 f"expected {(flash_forwards(cfg32), n_attn)}")
        worst = 0.0
        for pname, want in gc_cpu.items():
            top = float(want.abs().max())
            e = float((gc_card[pname].cpu() - want).abs().max())
            worst = max(worst, e / max(top, 1e-30))
            if e > TRAIN_GRAD_TOL * top:
                raise AssertionError(f"train {cfg32.name}: the card's gradient of {pname} is "
                                     f"{e} from the CPU's, over {TRAIN_GRAD_TOL} x {top}")
        qkv = [float(gc_card[f"layers.{i}.attn.{w}"].abs().max())
               for i, kind in enumerate(cfg32.layer_kinds) if kind in attention_mod.ATTN_KINDS
               for w in ("wq", "wk", "wv")]
        if min(qkv) <= 0.0:
            raise AssertionError(f"train {cfg32.name}: a wq / wk / wv gradient is all zeros on "
                                 f"the card (the attention's gradient stopped at the kernel)")
        rel = abs(float(lc) - float(lh)) / abs(float(lh))
        if rel > 1e-5:
            raise AssertionError(f"train {cfg32.name}: loss {float(lc)} on the card, "
                                 f"{float(lh)} on the CPU")
        print(f"train {cfg32.name} float32: loss {float(lc):.6f} on the card, {float(lh):.6f} "
              f"on the CPU (rel {rel:.2e}); {len(gc_cpu)} gradients, largest difference "
              f"{worst:.2e} of the gradient's largest magnitude (tolerance {TRAIN_GRAD_TOL:g}); "
              f"flash forward and backward launches {ran}; the smallest wq/wk/wv gradient "
              f"max {min(qkv):.3g} > 0 {card}")
        del on_cpu, on_card, gc_card, gc_cpu

    # (d) yi-9b at full widths, cut to its first TRAIN_LAYERS layers, through Trainer
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    ckpt_dir = ROOT / "build" / "ckpt-smoke"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    free_gb = shutil.disk_usage(ckpt_dir).free / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LMModel(cfg)                   # uninitialised; Trainer.init_state draws it
    pipe = pipeline_for(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    fired = []

    def injector(step):
        if step == TRAIN_FAIL_AT and not fired:
            fired.append(step)
            raise SimulatedNodeFailure(f"node lost before step {step}'s batch")

    ckpt_mgr = CheckpointManager(str(ckpt_dir), keep=1)
    saved_steps = []                       # the steps of the checkpoints written
    save = ckpt_mgr.save

    def counted_save(step, tree, blocking=False):
        saved_steps.append(step)
        save(step, tree, blocking)

    ckpt_mgr.save = counted_save
    trainer = Trainer(
        model, pipe,
        TrainConfig(num_steps=TRAIN_STEPS, microbatches=TRAIN_MICROBATCHES,
                    ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=str(ckpt_dir), log_every=1, seed=0),
        opt_cfg=AdamWConfig(),
        sched_cfg=ScheduleConfig(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS),
        checkpoint_mgr=ckpt_mgr,
        failure_injector=injector,
    )
    state = trainer.init_state()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    state_gb = torch.cuda.memory_allocated() / 2**30
    reset_counts()
    t0 = time.perf_counter()
    result = trainer.train(state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    hist = result["history"]
    steps_run = [m["step"] for m in hist]
    want_steps = sorted(list(range(1, TRAIN_STEPS + 1)) + [TRAIN_FAIL_AT])
    if steps_run != want_steps or result["failures"] != 1 or result["step"] != TRAIN_STEPS:
        raise AssertionError(f"train {cfg.name}: steps logged {steps_run}, failures "
                             f"{result['failures']}, final step {result['step']}")
    first, again = ({kk: vv for kk, vv in m.items() if kk != "step_time_s"}
                    for m in hist if m["step"] == TRAIN_FAIL_AT)
    if first != again:
        raise AssertionError(f"train {cfg.name}: the replayed step {TRAIN_FAIL_AT} gave "
                             f"{again}, the first attempt {first}")
    if not all(math.isfinite(m["loss"]) for m in hist):
        raise AssertionError(f"train {cfg.name}: a loss is not finite")
    per_step = TRAIN_LAYERS * TRAIN_MICROBATCHES
    fwd_step = flash_forwards(cfg) * TRAIN_MICROBATCHES
    expect = {kk: 0 for kk in launches}
    expect.update(flash_attention=fwd_step * len(hist), flash_attention_bwd=per_step * len(hist))
    if counts != expect:
        raise AssertionError(f"train {cfg.name}: launches {counts} over {len(hist)} steps, "
                             f"expected {expect}")
    for kk in launches:
        launches[kk] += counts[kk]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_lines = "; ".join(
        f"step {m['step']}: loss {m['loss']:.6f} ce {m['ce']:.6f} {m['step_time_s']:.3f} s "
        f"{tokens / m['step_time_s']:.0f} tokens/s" for m in hist)
    print(f"train {cfg.name} ({TRAIN_LAYERS} of 48 layers at full widths, {n_params:,} "
          f"parameters, bfloat16; AdamW float32 moments; global batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} in {TRAIN_MICROBATCHES} microbatches; checkpoint every "
          f"{TRAIN_CKPT_EVERY} steps; a failure before step {TRAIN_FAIL_AT}'s batch): "
          f"{step_lines}; the replayed step {TRAIN_FAIL_AT} equal bit for bit; {wall:.1f} s "
          f"wall for {len(hist)} steps and {len(saved_steps)} checkpoints (steps "
          f"{saved_steps}) "
          f"({free_gb:.0f} GB free for them); flash forward {counts['flash_attention']} "
          f"({fwd_step} a step: remat {cfg.remat}, policy {cfg.remat_policy!r}) and "
          f"backward {counts['flash_attention_bwd']} launches ({per_step} a step: "
          f"{TRAIN_LAYERS} layers x {TRAIN_MICROBATCHES} microbatches) over {len(hist)} steps; "
          f"memory {state_gb:.2f} GiB after init, peak {peak_gb:.2f} GiB {card}")

    # one more step under the profiler
    batch = pipe.batch_at(TRAIN_STEPS)
    rows, wall_us = trace(f"train {cfg.name} step", lambda: trainer.step_fn(
        result["state"]["params"], result["state"]["opt"], batch))
    busy = sum(r[0] for r in rows)
    fwd_us = sum(r[0] for r in rows if "flash_attention" in r[2])
    bwd_us = sum(r[0] for r in rows if "flash_bwd" in r[2])
    gemm_us = sum(r[0] for r in rows if any(w in r[2].lower() for w in
                                            ("nvjet", "gemm", "gemv", "xmma", "cutlass")))
    print(f"train profile {cfg.name} step: device busy {busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} "
          f"ms wall under the profiler ({100 * busy / max(wall_us, 1e-9):.1f}%), flash forward "
          f"{fwd_us / 1e3:.2f} ms ({100 * fwd_us / max(busy, 1e-9):.1f}% of busy), flash "
          f"backward {bwd_us / 1e3:.2f} ms ({100 * bwd_us / max(busy, 1e-9):.1f}%), matmuls "
          f"{gemm_us / 1e3:.2f} ms ({100 * gemm_us / max(busy, 1e-9):.1f}%), "
          f"{sum(r[1] for r in rows)} device operations {card}")
    del model, pipe, trainer, state, result, batch, rows
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (e) remat on the card: one microbatch of the same 8-layer model with
    # remat (the default) and without, every gradient bit for bit; then the
    # flash forward that the recomputation runs again, its output and
    # log-sum-exp bit for bit at the training shape.
    model = LMModel(cfg).init(0)
    batch = pipeline_for(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(0)
    batch = {kk: vv[:TRAIN_BATCH // TRAIN_MICROBATCHES] for kk, vv in batch.items()}
    runs, peaks = {}, {}
    for remat in (True, False):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _, grads = value_and_grad(model, dict(model.named_parameters()), batch)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - start) / 2**30
        runs[remat] = (loss, grads)
    differ = [n for n, g in runs[True][1].items() if not torch.equal(g, runs[False][1][n])]
    if not torch.equal(runs[True][0], runs[False][0]) or differ:
        raise AssertionError(f"train {cfg.name}: under remat the loss {float(runs[True][0])} "
                             f"(without {float(runs[False][0])}), gradients differ: {differ[:4]}")
    n_grads = len(runs[True][1])
    del model, batch, runs, grads, loss
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(7)
    qkv = [torch.randn(FLASH_BWD_TRAIN[:3] + FLASH_BWD_TRAIN[4:], generator=gen, device=dev,
                       dtype=torch.bfloat16) for _ in range(3)]
    first, again = (torch.ops.repro_torch.flash_fwd(*qkv, True, 0, 0.0, True) for _ in range(2))
    if not (torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])):
        raise AssertionError("flash forward at the training shape: a second call's output or "
                             "log-sum-exp differs from the first's")
    print(f"train {cfg.name} remat on the card: one microbatch ({TRAIN_BATCH // TRAIN_MICROBATCHES}"
          f" x {TRAIN_SEQ}) under remat (policy 'nothing') and without: the loss and all "
          f"{n_grads} gradients equal bit for bit; peak memory above the start {peaks[True]:.2f} GiB "
          f"under remat against {peaks[False]:.2f} GiB without; the flash forward at "
          f"{FLASH_BWD_TRAIN[:3] + FLASH_BWD_TRAIN[4:]} bf16 causal twice: output and "
          f"log-sum-exp equal bit for bit {card}")
    del qkv, first, again
    gc.collect()
    torch.cuda.empty_cache()

    # the launcher, once, on the card
    launch_dir = ROOT / "build" / "ckpt-launch"
    shutil.rmtree(launch_dir, ignore_errors=True)
    before = read_counts()
    t0 = time.perf_counter()
    rc = train_launch.main(["--arch", "yi-9b", "--reduced", "--steps", "4", "--batch", "4",
                            "--seq", "64", "--microbatches", "2", "--warmup", "1",
                            "--ckpt-dir", str(launch_dir), "--ckpt-every", "2"])
    torch.cuda.synchronize()
    after = read_counts()
    shutil.rmtree(launch_dir, ignore_errors=True)
    ran = {kk: after[kk] - before[kk] for kk in after}
    if rc != 0 or not ran["flash_attention"] or not ran["flash_attention_bwd"]:
        raise AssertionError(f"python -m repro_torch.launch.train: rc {rc}, launches {ran}")
    for kk in launches:
        launches[kk] += ran[kk]
    print(f"python -m repro_torch.launch.train --arch yi-9b --reduced --steps 4 (on the card): "
          f"rc {rc} in {time.perf_counter() - t0:.1f} s, flash forward "
          f"{ran['flash_attention']} and backward {ran['flash_attention_bwd']} launches {card}")

    # ---- 20. the mesh ------------------------------------------------------
    # Trainer and ServeEngine under a DeviceMesh over the card.  On a mesh of
    # one device every local operation sees the whole tensor, so every result
    # must equal the same run without the mesh bit for bit; the two flash
    # kernels run through local_map on the DTensors' local shards.
    phase_starts(20)
    t_mesh = time.perf_counter()
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_mesh, make_rules
    from repro_torch.models.model import shard_model
    from repro_torch.runtime.fault_tolerance import elastic_reshard

    store = ROOT / "build" / "mesh-store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))

        def shown(rules_):
            return {kk: vv for kk, vv in dataclasses.asdict(rules_).items() if vv is not None}

        retraced_s = []

        def traced_step(label, fn):
            """(fn's result, the device rows of a trace of one call, that call's
            wall ms under the profiler).  The trace records the device's
            activity only: recording a DTensor step's host operations as well
            took seconds a trace."""
            box = {}

            def call():
                box.clear()
                t0 = time.perf_counter()
                box["out"] = fn()
                box["ms"] = (time.perf_counter() - t0) * 1e3

            rows = traced_rows(call, 1, label)
            return box["out"], rows, box["ms"]

        def settled_ms(label, fn, rows, wall_ms):
            """The device busy ms of one call of ``fn``, from ``rows`` (a trace of
            one call) and traces of more calls, their results dropped, and the
            wall ms under the profiler of the first call and of the last.  A
            trace can lose records, so calls are traced until two traces agree
            on the device operations within one in a hundred, the fuller giving
            the busy time; the run fails after five more that do not."""
            t0, first_ms = time.perf_counter(), wall_ms
            for _ in range(5):
                _, again, wall_ms = traced_step(f"{label} (again)", fn)
                ops = [sum(r[1] for r in t) for t in (rows, again)]
                agree = abs(ops[0] - ops[1]) <= max(ops) // 100
                if ops[1] > ops[0]:
                    rows = again
                if agree:
                    retraced_s.append(time.perf_counter() - t0)
                    return sum(r[0] for r in rows) / 1e3, first_ms, wall_ms
            raise AssertionError(f"{label}: no two traces agree on the device operations")

        # (a) one Trainer step of phase 19's model, batch and seed
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
        rules = make_rules(cfg, mesh, global_batch=TRAIN_BATCH, shape_name="train_4k")
        pipe = pipeline_for(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
        batch = pipe.batch_at(0)
        model = LMModel(cfg)
        trainer = Trainer(
            model, pipe,
            TrainConfig(num_steps=1, microbatches=TRAIN_MICROBATCHES, log_every=1, seed=0,
                        ckpt_dir=str(ROOT / "build" / "ckpt-mesh")),
            opt_cfg=AdamWConfig(),
            # no warmup: the step's rate is not 0, so it moves every weight
            sched_cfg=ScheduleConfig(peak_lr=3e-4, warmup_steps=0, total_steps=TRAIN_STEPS))

        def one_step():
            state = trainer.init_state()
            params, opt, metrics = trainer.step_fn(state["params"], state["opt"], batch)
            torch.cuda.synchronize()
            return params, opt, metrics

        # each step starts from init_state, so a step traced again (the
        # timing's retakes) leaves the model's weights as the first left them
        label = f"mesh train {cfg.name} step without the mesh"
        reset_counts()
        (params, opt, want_metrics), rows, wall_ms = traced_step(label, one_step)
        want_params = {n: p.detach().clone() for n, p in params.items()}
        # the moments (15 GB in float32) wait in host memory
        want_moments = {mm: {n: x.cpu() for n, x in opt[mm].items()} for mm in ("m", "v")}
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        plain_busy, plain_wall, plain_again = settled_ms(label, one_step, rows, wall_ms)
        gc.collect()
        torch.cuda.empty_cache()
        shard_model(model, mesh, rules)
        with sharding.use_mesh(mesh), sharding.use_rules(rules):
            label = f"mesh train {cfg.name} step under the mesh"
            reset_counts()
            (params, opt, metrics), rows, wall_ms = traced_step(label, one_step)
            counts = read_counts()
            expect = {kk: 0 for kk in launches}
            expect.update(flash_attention=flash_forwards(cfg) * TRAIN_MICROBATCHES,
                          flash_attention_bwd=TRAIN_LAYERS * TRAIN_MICROBATCHES)
            if counts != expect:
                raise AssertionError(f"mesh train {cfg.name}: launches {counts}, expected "
                                     f"{expect}")
            for kk in launches:
                launches[kk] += counts[kk]
            not_dt = [n for n, p in params.items() if not isinstance(p, DTensor)]
            if not_dt:
                raise AssertionError(f"mesh train {cfg.name}: parameters not DTensors: "
                                     f"{not_dt[:4]}")
            moved = [n for n, p in params.items()
                     if not torch.equal(p.full_tensor(), want_params[n])]
            moved += [f"{mm} {n}" for mm in ("m", "v") for n, x in opt[mm].items()
                      if not isinstance(x, DTensor)
                      or not torch.equal(x.full_tensor(), want_moments[mm][n].to(dev))]
            bad_metrics = [kk for kk, vv in want_metrics.items()
                           if not torch.equal(sharding.full(metrics[kk]), sharding.full(vv))]
            if moved or bad_metrics:
                raise AssertionError(f"mesh train {cfg.name}: under the mesh {len(moved)} "
                                     f"parameters or moments differ ({moved[:4]}), metrics "
                                     f"{bad_metrics}")
            del params, opt, want_moments
            gc.collect()
            torch.cuda.empty_cache()
            mesh_busy, mesh_wall, mesh_again = settled_ms(label, one_step, rows, wall_ms)
        print(f"mesh train {cfg.name} ({TRAIN_LAYERS} layers, global batch {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} in {TRAIN_MICROBATCHES} microbatches) on a (1, 1) ('data', 'model') "
              f"mesh, rules {shown(rules)}: loss {float(sharding.full(metrics['loss'])):.6f}, "
              f"ce, grad norm, rate {float(sharding.full(metrics['lr'])):.3g} and all "
              f"{len(want_params)} parameters and their AdamW moments after the step equal to "
              f"the step without the mesh bit for bit; flash forward {counts['flash_attention']} and "
              f"backward {counts['flash_attention_bwd']} launches on local shards; the step's "
              f"device busy time {mesh_busy:.2f} ms under the mesh against {plain_busy:.2f} ms "
              f"without; wall under the profiler {mesh_wall:.1f} ms under the mesh against "
              f"{plain_wall:.1f} without, the same step traced again {mesh_again:.1f} against "
              f"{plain_again:.1f} {card}")

        # (b) elastic_reshard onto a (1, 1, 1) mesh, a checkpoint, a resharded restore
        t_reshard = time.perf_counter()
        mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"))
        rules3 = make_rules(cfg, mesh3, global_batch=TRAIN_BATCH, shape_name="train_4k")
        specs = model.param_specs()
        trained = dict(model.named_parameters())
        del metrics, trainer
        gc.collect()
        torch.cuda.empty_cache()
        resharded = elastic_reshard(trained, specs, mesh3, rules3)

        def check_laid_out(tree, what):
            for n, x in tree.items():
                want = sharding.spec_to_placements(
                    sharding.logical_to_spec(specs[n], rules3, mesh3), mesh3)
                if (not isinstance(x, DTensor) or x.device_mesh != mesh3
                        or tuple(x.placements) != want
                        or not torch.equal(x.full_tensor(), want_params[n])):
                    raise AssertionError(f"mesh {what}: {n} is not the trained parameter laid "
                                         f"out as {want}")

        check_laid_out(resharded, "elastic_reshard")
        ckpt_dir = ROOT / "build" / "ckpt-mesh"
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        ckpt = CheckpointManager(str(ckpt_dir), keep=1)
        t0 = time.perf_counter()
        ckpt.save(1, {"params": resharded}, blocking=True)
        t_save = time.perf_counter() - t0
        with sharding.use_rules(rules3):
            named = {n: sharding.named_sharding(mesh3, *axes) for n, axes in specs.items()}
        t0 = time.perf_counter()
        step, restored = ckpt.restore({"params": resharded}, device=dev,
                                      sharding_tree={"params": named})
        t_restore = time.perf_counter() - t0
        check_laid_out(restored["params"], "restore(sharding_tree=...)")
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        print(f"mesh elastic_reshard of the {len(specs)} trained parameters onto a (1, 1, 1) "
              f"('pod', 'data', 'model') mesh, rules {shown(rules3)}, then a checkpoint of them "
              f"({t_save:.1f} s) and restore(sharding_tree=...) onto that mesh ({t_restore:.1f} "
              f"s): every leaf bit-equal, in the placements its rules give {card}")
        del model, pipe, batch, trained, resharded, restored, want_params
        gc.collect()
        torch.cuda.empty_cache()

        # (c) phase 11's yi-9b through ServeEngine on its first wave
        t_serve = time.perf_counter()
        cfg = get_config("yi-9b")
        n_attn = sum(kk in attention_mod.ATTN_KINDS for kk in cfg.layer_kinds)
        model = LMModel(cfg).init(0)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, LM_PROMPT_LEN + 1))
                   for _ in range(LM_REQUESTS)][:LM_BATCH]
        prompts = [pr[:MESH_PROMPT] for pr in prompts]
        steps = max(len(pr) + MESH_NEW - 1 for pr in prompts)
        apply = model.apply
        logits_seen, step_s = [], []

        def recording_apply(*args, **kwargs):
            out = apply(*args, **kwargs)
            logits_seen.append(sharding.full(out[0]).clone())
            return out

        def timed_step(model_, caches, tokens):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = decode_step(model_, caches, tokens)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out

        def serve():
            logits_seen.clear()
            step_s.clear()
            model.apply = recording_apply
            engine_mod.decode_step = timed_step
            try:
                return ServeEngine(model, batch=LM_BATCH, max_len=LM_MAX_LEN).generate(
                    prompts, MESH_NEW)
            finally:
                engine_mod.decode_step = decode_step
                del model.apply

        want_tokens = serve()
        want_logits, plain_steps = list(logits_seen), list(step_s)
        rules_s = make_rules(cfg, mesh, global_batch=LM_BATCH, shape_name="decode_32k")
        shard_model(model, mesh, rules_s)
        with sharding.use_mesh(mesh), sharding.use_rules(rules_s):
            reset_counts()
            tokens_ = serve()
            counts = read_counts()
        expect = {kk: n_attn * steps if kk == "flash_attention" else 0 for kk in launches}
        if counts != expect:
            raise AssertionError(f"mesh serve {cfg.name}: launches {counts} in {steps} decode "
                                 f"steps, expected {expect}")
        for kk in launches:
            launches[kk] += counts[kk]
        differ = [i for i, (g, w) in enumerate(zip(logits_seen, want_logits))
                  if not torch.equal(g, w)]
        if tokens_ != want_tokens or len(logits_seen) != steps or differ:
            raise AssertionError(f"mesh serve {cfg.name}: tokens {tokens_} against {want_tokens}, "
                                 f"{len(logits_seen)} steps, logits differ at steps {differ}")
        over = median_of(step_s) - median_of(plain_steps)
        print(f"mesh serve {cfg.name} ({cfg.num_layers} layers) through ServeEngine(batch="
              f"{LM_BATCH}, max_len={LM_MAX_LEN}) on phase 11's first wave, {MESH_NEW} new "
              f"tokens, {steps} decode steps, under the (1, 1) mesh with rules {shown(rules_s)}: "
              f"every step's logits equal to the run without the mesh bit for bit, tokens "
              f"equal, flash {counts['flash_attention']} launches on local shards; a decode "
              f"step (host clock, synchronised) median {1e3 * median_of(step_s):.2f} ms under "
              f"the mesh against {1e3 * median_of(plain_steps):.2f} ms without: DTensor "
              f"dispatch overhead {1e3 * over:.2f} ms a step ({1e3 * over / n_attn:.3f} ms a "
              f"layer) {card}")
        del model, want_logits
        logits_seen.clear()
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    t_end = time.perf_counter()
    print(f"mesh phase: {t_end - t_mesh:.1f} s wall (the training step without and under the "
          f"mesh {t_reshard - t_mesh:.1f} s, {sum(retraced_s):.1f} s of it steps traced again; "
          f"reshard, checkpoint and restore {t_serve - t_reshard:.1f} s; serving "
          f"{t_end - t_serve:.1f} s) {card}")

    # ---- 21. the dry run -----------------------------------------------------
    # launch/dryrun.run_cell over a fake process group of 256 ranks and a fake
    # cuda (16, 16) mesh: the step traced on fake tensors under the three
    # meters; the flash ops run their fake implementations (no launch).
    phase_starts(21)
    t_dry = time.perf_counter()
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun

    before = read_counts()
    for arch, shape_name in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape_name, verbose=False)
        if dist.is_initialized():
            raise AssertionError("dryrun.run_cell left its process group initialised")
        cfg, spec = get_config(arch), SHAPES[shape_name]
        decode = spec.mode == "decode"
        # the flash ops at the local shapes: batch over "data" (16), heads over
        # "model" (16), every key of the sequence (gathered where it is split)
        b_local, h_local = spec.global_batch // 16, cfg.num_heads // 16
        pairs = flash_kernel.visible_pairs(1 if decode else spec.seq_len, spec.seq_len,
                                           not decode, 0)
        want_flops = cfg.num_layers * 4 * b_local * h_local * cfg.head_dim * pairs
        mem = rec["memory"]
        peak_gib = mem["peak_bytes"] / 2**30
        if (rec["flash_calls"] != {"forward": cfg.num_layers, "backward": 0}
                or rec["flash_flops"] != want_flops or rec["device_type"] != "cuda"
                or rec["mesh"] != "16x16" or not rec["flops"] > rec["flash_flops"]
                or rec["collectives"]["count"] <= 0 or not 0 < peak_gib < DRYRUN_PEAK_GIB):
            raise AssertionError(f"dry run {arch} x {shape_name}: {json.dumps(rec)[:3000]}")
        coll = {kk: vv for kk, vv in rec["collectives"].items() if vv}
        print(f"dry run {arch} x {shape_name} x {rec['mesh']} on fake cuda tensors: traced in "
              f"{time.perf_counter() - t0:.1f} s; flash {rec['flash_calls']['forward']} forward "
              f"calls, {rec['flash_flops']:.6g} flops = the formula's at ({b_local}, {h_local}, "
              f"{1 if decode else spec.seq_len}, {spec.seq_len}, {cfg.head_dim}) a device x "
              f"{cfg.num_layers} layers; flops a device {rec['flops']:.6g}; collectives {coll}; "
              f"memory a device: peak {peak_gib:.3f} GiB (arguments "
              f"{mem['argument_bytes'] / 2**30:.3f}, temporaries {mem['temp_bytes'] / 2**30:.3f},"
              f" outputs {mem['output_bytes'] / 2**30:.4f}), at the peak "
              f"{ {kk: round(vv / 2**30, 3) for kk, vv in mem['breakdown'].items()} } GiB {card}")
    if read_counts() != before:
        raise AssertionError(f"dry run: kernels launched: {read_counts()} against {before}")
    print(f"dry-run phase: {time.perf_counter() - t_dry:.1f} s wall {card}")

    # ---- 22. the examples -----------------------------------------------------
    # examples/torch_*.py through their main() in this process on the card,
    # each output held as the CPU tests hold it against the JAX package: here
    # against the port's CPU run or the card's single-frame output; then the
    # quickstart once as users run it, in a subprocess.
    phase_starts(22)
    t_examples = time.perf_counter()
    import importlib.util
    import shutil
    import tempfile

    example_dir = ROOT / "build" / "examples"
    shutil.rmtree(example_dir, ignore_errors=True)
    example_dir.mkdir(parents=True)
    stereo_kernels = ("support_match", "sobel", "dense_match_stream", "median3x3")

    def example(name):
        path = ROOT / "examples" / f"torch_{name}.py"
        spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def run_example(label, name, argv, want=None):
        """(main's result, its launches): ``want`` maps kernels to the
        launches the run must make (every kernel not named: 0), or is a
        function of the result that gives that map."""
        reset_counts()
        t0 = time.perf_counter()
        out = example(name).main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        for kk in launches:
            launches[kk] += counts[kk]
        print(f"example {label}: {wall:.2f} s wall, launches "
              f"{ {kk: c for kk, c in counts.items() if c} } {card}")
        if want is not None:
            want = want(out) if callable(want) else want
            expect = {kk: want.get(kk, 0) for kk in counts}
            if counts != expect:
                raise AssertionError(f"example {label}: launches {counts}, expected {expect}")
        return out, counts

    # the quickstart: two iELAS frames and two baseline frames, one launch of
    # each stereo kernel a frame; both maps equal to the port's CPU output
    quick, _ = run_example("torch_quickstart", "quickstart", [],
                           {kk: 4 for kk in stereo_kernels})
    il, ir, _ = synthetic_stereo_pair(height=240, width=320, d_max=40, n_objects=5, seed=7)
    il, ir = np.asarray(il, np.float32), np.asarray(ir, np.float32)
    for key, fn in (("ielas", pipeline.ielas_disparity),
                    ("baseline", pipeline.elas_baseline_disparity)):
        mism = int((fn(il, ir, SYNTH.params, device="cpu").numpy() != quick[key]).sum())
        print(f"example torch_quickstart {key} 240x320: card vs CPU mismatches {mism} of "
              f"{quick[key].size} {card}")
        if mism:
            raise AssertionError(f"example torch_quickstart: the {key} map differs from the CPU's")
    print(f"example torch_quickstart: iELAS {quick['ielas_s'] * 1e3:.3f} ms a frame "
          f"({1 / quick['ielas_s']:.2f} fps), baseline {quick['hybrid_s'] * 1e3:.3f} ms "
          f"({1 / quick['hybrid_s']:.2f} fps), first call {quick['first_call_s']:.3f} s {card}")

    # stereo serving: the first call, every frame single, the warm-up's dummy
    # wave and the service's waves, one launch of each stereo kernel each;
    # every delivered frame equal to the card's single-frame output of its pair
    def stereo_launches(out):
        n = 1 + len(out["serial"]) + 1 + out["stats"].waves
        return {kk: n for kk in stereo_kernels}

    for label, argv in (("defaults", []),
                        ("KITTI 375x1242", ["--streams", str(EXAMPLE_KITTI_STREAMS),
                                            "--frames", str(EXAMPLE_KITTI_STREAMS),
                                            "--height", "375", "--width", "1242"])):
        served, _ = run_example(f"torch_stereo_serving {label}", "stereo_serving", argv,
                                stereo_launches)
        done, st = served["done"], served["stats"]
        bad = [c.error for c in done if not c.ok]
        mism = sum(int((c.disparity != served["serial"][(c.stream_id, c.frame_id)].cpu()
                        .numpy()).sum()) for c in done if c.ok)
        print(f"example torch_stereo_serving {label}: {len(done)} delivered, {len(bad)} "
              f"failed, mismatches {mism} against the single-frame outputs; single-frame "
              f"{served['single_fps']:.2f} fps, service {served['service_fps']:.2f} fps, "
              f"{st.waves} waves, occupancy {st.wave_occupancy:.3f}, p50 "
              f"{st.latency_p50_ms:.3f} ms, p95 {st.latency_p95_ms:.3f} ms {card}")
        if bad or mism or len(done) != len(served["serial"]) or st.cache_misses:
            raise AssertionError(f"example torch_stereo_serving {label}: failed {bad[:2]}, "
                                 f"{mism} mismatches, {st.cache_misses} misses")
        del served, done

    # LM serving: one flash launch a layer a decode step; each wave of 4 runs
    # until its longest request's prompt and 32 new tokens are through (the
    # last wave padded with one-token prompts)
    lm_example = example("lm_serving")
    lm_layers = lm_example.CFG.num_layers

    def lm_launches(out):
        lens = [len(pr) for pr in out["prompts"]]
        waves = [lens[i:i + 4] + [1] * (4 - len(lens[i:i + 4])) for i in range(0, len(lens), 4)]
        return {"flash_attention": lm_layers * sum(max(n + 32 - 1 for n in w) for w in waves)}

    served, counts = run_example("torch_lm_serving", "lm_serving", [], lm_launches)
    if served["tokens"] != 32 * len(served["prompts"]) or any(
            not all(0 <= t < lm_example.CFG.vocab_size for t in o) for o in served["outs"]):
        raise AssertionError(f"example torch_lm_serving: {served['tokens']} tokens")
    print(f"example torch_lm_serving: {served['tokens']} tokens in {served['seconds']:.3f} s = "
          f"{served['tokens_per_s']:.2f} tokens/s, flash (D = "
          f"{lm_example.CFG.d_model // lm_example.CFG.num_heads}) launched "
          f"{counts['flash_attention']} times = {lm_layers} layers x decode steps {card}")

    # training: the fast preset at its defaults (200 steps), then the 100m
    # preset; ce falls, each layer's backward runs once a microbatch a step
    train_example = example("train_lm")
    for preset, argv in (("fast", []), ("100m", ["--preset", "100m", "--steps",
                                                 str(EXAMPLE_TRAIN_STEPS)])):
        cfg = train_example.PRESETS[preset]
        steps = EXAMPLE_TRAIN_STEPS if preset == "100m" else 200
        trained, counts = run_example(
            f"torch_train_lm {preset}", "train_lm",
            argv + ["--ckpt-dir", str(example_dir / f"ckpt-{preset}")])
        hist = trained["history"]
        ces = [h["ce"] for h in hist]
        step_s = sorted(h["step_time_s"] for h in hist)
        print(f"example torch_train_lm {preset} ({trained['params']:,} parameters, D = "
              f"{cfg.d_model // cfg.num_heads}): ce {ces[0]:.4f} -> {ces[-1]:.4f} over "
              f"{trained['step']} steps, s/step median {step_s[len(step_s) // 2]:.4f} (min "
              f"{step_s[0]:.4f}, max {step_s[-1]:.4f}), flash forward "
              f"{counts['flash_attention']} and backward {counts['flash_attention_bwd']} "
              f"launches {card}")
        if (trained["step"] != steps or not all(math.isfinite(c) for c in ces)
                or not ces[-1] < ces[0]):
            raise AssertionError(f"example torch_train_lm {preset}: ce {ces}")
        if (counts["flash_attention_bwd"] != cfg.num_layers * 2 * steps
                or counts["flash_attention"] < counts["flash_attention_bwd"]):
            raise AssertionError(f"example torch_train_lm {preset}: launches {counts}")
        del trained
        shutil.rmtree(example_dir / f"ckpt-{preset}", ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    # the fault-tolerance demo: its checkpoints under build/; 2 failures
    # recovered, a diff of exactly 0.0 between two models' distinct tensors,
    # the heartbeat's verdicts those the CPU test pins
    tempfile.tempdir, saved_tempdir = str(example_dir), tempfile.tempdir
    try:
        demo, counts = run_example("torch_fault_tolerance_demo", "fault_tolerance_demo", [])
    finally:
        tempfile.tempdir = saved_tempdir
    shared = [n for n in demo["params"] if demo["params"][n].untyped_storage().data_ptr()
              == demo["clean_params"][n].untyped_storage().data_ptr()]
    print(f"example torch_fault_tolerance_demo: {demo['failures']} failures recovered, step "
          f"{demo['step']}, max param diff {demo['max_param_diff']} over "
          f"{len(demo['params'])} tensors ({len(shared)} sharing storage), dead hosts "
          f"{demo['dead_hosts']}, stragglers {demo['stragglers']}, restored step "
          f"{demo['restored_step']} with {demo['restored_leaves']} leaves; flash forward "
          f"{counts['flash_attention']} and backward {counts['flash_attention_bwd']} "
          f"launches {card}")
    if (demo["failures"] != 2 or demo["step"] != 20 or demo["max_param_diff"] != 0.0 or shared
            or demo["dead_hosts"] != ["host1"] or demo["stragglers"] != ["host2"]
            or not counts["flash_attention"] or not counts["flash_attention_bwd"]):
        raise AssertionError("example torch_fault_tolerance_demo failed its checks")
    del demo

    # the quickstart as users run it
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "examples/torch_quickstart.py"], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=600)
    print(f"python examples/torch_quickstart.py: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.2f} s; "
          + " | ".join([ln for ln in proc.stdout.splitlines() if ln.strip()][-7:]))
    if proc.returncode != 0 or "valid pixels:" not in proc.stdout:
        raise AssertionError(f"examples/torch_quickstart.py failed: {proc.stderr[-2000:]}")
    shutil.rmtree(example_dir, ignore_errors=True)
    print(f"examples phase: {time.perf_counter() - t_examples:.1f} s wall {card}")

    # ---- 23. summary -------------------------------------------------------
    phase_starts(23)
    shown = {**SHOWN, "flash_attention_bwd": train_label}
    entries = []
    for kname, _, _, source, replaces in kernels:
        if launches[kname] == 0:
            raise AssertionError(f"{kname} was never launched on the main path")
        r = results[(kname, shown.get(kname, "elas-kitti"))]
        entries.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
