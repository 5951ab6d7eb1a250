"""Each CUDA kernel of the port against its plain PyTorch version (tests
marked ``gpu``: they skip without a card), and the ctypes bindings against
the C launchers' signatures (runs everywhere).  Imports no JAX, so it runs
on a machine with a card and without JAX:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import ctypes
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import dense_match as dense_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import median as median_kernel
from repro_torch.kernels import sobel as sobel_kernel
from repro_torch.kernels import support_match as support_kernel
from torch_kernel_cases import (
    DENSE_CASES,
    MEDIAN_CASES,
    SOBEL_CASES,
    SUPPORT_CASES,
    SUPPORT_WIDE_CASES,
    WARM_CASES,
    WINDOWED_CASES,
    dense_inputs,
    median_map,
    median_stack,
    sobel_image,
    support_inputs,
    warm_inputs,
    windowed_inputs,
)

_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}


@pytest.mark.parametrize("source,symbol,argtypes", [
    ("support_match", "ielas_support_match", support_kernel.ARGTYPES),
    ("dense_match_stream", "ielas_dense_match_stream", dense_kernel.ARGTYPES),
    ("dense_match_stream", "ielas_xla_exp_log", dense_kernel.EXP_LOG_ARGTYPES),
    ("dense_match_windowed", "ielas_dense_match_windowed", dense_kernel.WINDOWED_ARGTYPES),
    ("dense_match_warm", "ielas_dense_match_warm", dense_kernel.WARM_ARGTYPES),
    ("dense_match_warm", "ielas_warm_reciprocal", dense_kernel.WARM_RECIPROCAL_ARGTYPES),
    ("sobel", "ielas_sobel", sobel_kernel.ARGTYPES),
    ("median", "ielas_median3x3", median_kernel.ARGTYPES),
    ("flash_attention", "ielas_flash_attention_lse", flash_kernel.ARGTYPES),
    ("flash_attention_bwd", "ielas_flash_attention_bwd", flash_kernel.BWD_ARGTYPES),
])
def test_binding_matches_launcher_signature(source, symbol, argtypes):
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, f"no extern C launcher {symbol} in csrc/{source}.cu"
    params = [" ".join(p.split()[:-1]).replace("const ", "").replace(" *", "*")
              for p in m.group(1).split(",")]
    assert [_C_TYPES[p] for p in params] == argtypes
    assert source in _build.sources()
    assert _build.library_path(source).parent == _build.BUILD_DIR


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares a CUDA kernel with its plain version")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SUPPORT_CASES, ids=[c[0] for c in SUPPORT_CASES])
def test_support_kernel_matches_plain_on_card(case, cuda_device):
    dl, dr, kw = support_inputs(case)
    tl, tr = torch.as_tensor(dl, device=cuda_device), torch.as_tensor(dr, device=cuda_device)
    before = support_kernel.launches
    got = support_kernel.support_match(tl, tr, **kw)
    torch.cuda.synchronize()
    assert support_kernel.launches == before + 1
    assert torch.equal(got, ref.support_match_rows_streaming(tl, tr, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("case", SUPPORT_WIDE_CASES, ids=[c[0] for c in SUPPORT_WIDE_CASES])
def test_support_kernel_any_span_split_on_card(case, cuda_device):
    """Rows too wide for one block's shared memory, split into 2, 4 and 8
    spans (the cross-check reading other blocks' shared memory), give the
    plain version's grid."""
    dl, dr, kw = support_inputs(case)
    tl, tr = torch.as_tensor(dl, device=cuda_device), torch.as_tensor(dr, device=cuda_device)
    got = support_kernel.support_match(tl, tr, **kw)
    assert torch.equal(got, ref.support_match_rows_streaming(tl, tr, **kw))
    assert int((got != -1.0).sum()) > 0


@pytest.mark.gpu
def test_support_kernel_reads_strided_candidate_rows_on_card(cuda_device):
    """A wave's descriptor maps, read through the candidate rows' strided
    view (core/support.py's path), against the plain version on the
    gathered rows."""
    from repro_torch.core.support import candidate_rows

    rng = np.random.default_rng(4)
    maps = rng.integers(-40, 41, (2, 3, 47, 97, 16)).astype(np.int8)
    maps[1, :, :, :90] = maps[0, :, :, 7:]                 # the right view shifted by 7
    dl, dr = (torch.as_tensor(m, device=cuda_device) for m in maps)
    _, _, kw = support_inputs(SUPPORT_CASES[0])
    step = kw["step"]
    got = support_kernel.support_match(candidate_rows(dl, step), candidate_rows(dr, step), **kw)
    vs = torch.arange(47 // step, device=cuda_device) * step + step // 2
    want = ref.support_match_rows_streaming(dl[:, vs].flatten(0, 1), dr[:, vs].flatten(0, 1), **kw)
    assert torch.equal(got, want.reshape(got.shape))
    assert int((got != -1.0).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_dense_kernel_matches_plain_on_card(case, cuda_device):
    dl, dr, mu, gm, kw = dense_inputs(case)
    args = [torch.as_tensor(a, device=cuda_device) for a in (dl, dr, mu[0], mu[1], gm[0], gm[1])]
    before = dense_kernel.launches
    got = dense_kernel.dense_match_stream(*args, **kw)
    torch.cuda.synchronize()
    assert dense_kernel.launches == before + 1
    want = ref.dense_match_rows_stream_ref(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("case", WINDOWED_CASES, ids=[c[0] for c in WINDOWED_CASES])
def test_windowed_kernel_matches_plain_on_card(case, cuda_device):
    dl, dr, mu, cand, kw = windowed_inputs(case)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (dl, dr, mu[0], mu[1], cand[0], cand[1])]
    before = dense_kernel.windowed_launches
    got = dense_kernel.dense_match_candidates(*args, **kw)
    torch.cuda.synchronize()
    assert dense_kernel.windowed_launches == before + 1
    want = ref.dense_match_rows_windowed_ref(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("case", SOBEL_CASES, ids=[c[0] for c in SOBEL_CASES])
def test_sobel_kernel_matches_plain_on_card(case, cuda_device):
    img = torch.as_tensor(sobel_image(case), device=cuda_device)
    before = sobel_kernel.launches
    got = sobel_kernel.sobel(img)
    torch.cuda.synchronize()
    assert sobel_kernel.launches == before + 1
    want = ref.sobel_rows_ref(*ref.edge_row_views(img.to(torch.int32)))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,offset", [(np.uint8, 1), (np.uint8, 3), (np.uint8, 7),
                                          (np.uint8, 15), (np.int32, 4), (np.float32, 12)])
def test_sobel_kernel_reads_rows_at_any_offset_on_card(dtype, offset, cuda_device):
    """A stack of both views of two frames at KITTI width (rows 1242
    elements apart) whose first byte lies `offset` bytes past a 16-byte
    boundary, as a wave's slices do: the kernel's 16-byte chunks equal the
    plain version."""
    rng = np.random.default_rng(offset)
    shape = (2, 2, 19, 1242)
    img = (rng.integers(0, 256, shape) if dtype == np.uint8
           else rng.uniform(-20, 256, shape)).astype(dtype)
    view = _at_offset(img, offset, cuda_device)
    assert view.data_ptr() % 16 == offset
    got = sobel_kernel.sobel(view)
    want = ref.sobel_rows_ref(*ref.edge_row_views(view.to(torch.int32)))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("w,gx_offset,gy_offset", [(1242, 1, 1), (1242, 3, 10), (1242, 15, 0),
                                                   (37, 8, 5), (15, 7, 9), (200, 0, 13)])
def test_sobel_kernel_writes_rows_at_any_offset_on_card(w, gx_offset, gy_offset, cuda_device):
    """gx and gy that start at other byte offsets than 16-byte boundaries,
    each its own (the kernel's entry point takes any): every output byte
    equals the plain version and no byte outside the maps is written."""
    rng = np.random.default_rng(w + gx_offset)
    img = torch.as_tensor(rng.integers(0, 256, (2, 11, w)).astype(np.uint8), device=cuda_device)
    n, h = img.shape[0], img.shape[1]
    guard = 32
    outs = []
    for offset in (gx_offset, gy_offset):
        raw = torch.full((offset + img.numel() + guard,), 0x5A, dtype=torch.uint8,
                         device=cuda_device)
        outs.append((raw, raw[offset : offset + img.numel()].view(torch.int8).view(img.shape)))
    err = sobel_kernel._kernel()(img.data_ptr(), outs[0][1].data_ptr(), outs[1][1].data_ptr(),
                                 n, h, w, sobel_kernel.KINDS[torch.uint8],
                                 torch.cuda.current_stream(cuda_device).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    want = ref.sobel_rows_ref(*ref.edge_row_views(img.to(torch.int32)))
    for (raw, got), offset, expect in zip(outs, (gx_offset, gy_offset), want):
        assert torch.equal(got, expect)
        assert bool((raw[:offset] == 0x5A).all())
        assert bool((raw[offset + img.numel():] == 0x5A).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", MEDIAN_CASES, ids=[c[0] for c in MEDIAN_CASES])
def test_median_kernel_matches_plain_on_card(case, cuda_device):
    disp = torch.as_tensor(median_map(case), device=cuda_device)
    before = median_kernel.launches
    got = median_kernel.median3x3(disp)
    torch.cuda.synchronize()
    assert median_kernel.launches == before + 1
    assert torch.equal(got, ref.median3x3_rows_ref(*ref.edge_row_views(disp)))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", range(4))
@pytest.mark.parametrize("case", MEDIAN_CASES, ids=[c[0] for c in MEDIAN_CASES])
def test_median_kernel_takes_stacks_at_any_offset_on_card(case, offset, cuda_device):
    """Two maps in one launch, read from a stack that starts `offset` floats
    past a 16-byte boundary (a wave's slices lie so)."""
    stack = torch.as_tensor(median_stack(case))
    raw = torch.full((stack.numel() + offset + 4,), 7.25, device=cuda_device)
    view = raw[offset:offset + stack.numel()].view(stack.shape)
    view.copy_(stack)
    before = median_kernel.launches
    got = median_kernel.median3x3(view)
    torch.cuda.synchronize()
    assert median_kernel.launches == before + 1
    assert torch.equal(got, ref.median3x3_rows_ref(*ref.edge_row_views(view)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", WARM_CASES, ids=[c[0] for c in WARM_CASES])
def test_warm_kernel_matches_plain_on_card(case, cuda_device):
    dl, dr, mu, kw = warm_inputs(case)
    args = [torch.as_tensor(a, device=cuda_device) for a in (dl, dr, mu[0], mu[1])]
    w = dl.shape[-2]           # a stack of frames: the plain version takes its rows

    def plain(**over):
        rows = (args[0].reshape(-1, w, 16), args[1].reshape(-1, w, 16),
                args[2].reshape(-1, w), args[3].reshape(-1, w))
        return [o.reshape(args[2].shape) for o in ref.dense_match_rows_warm_ref(
            *rows, **{**kw, **over})]

    before = dense_kernel.warm_launches
    got = dense_kernel.dense_match_warm(*args, **kw)
    torch.cuda.synchronize()
    assert dense_kernel.warm_launches == before + 1
    for g, x in zip(got, plain()):
        assert torch.equal(g, x)
    for sigma in (1.5, 0.7):
        got = dense_kernel.dense_match_warm(*args, **{**kw, "sigma": sigma})
        assert all(torch.equal(g, x) for g, x in zip(got, plain(sigma=sigma)))


@pytest.mark.gpu
def test_warm_reciprocal_is_a_correctly_rounded_division_on_card(cuda_device):
    """The warm kernel's fast reciprocal against a division, on every float32
    of [1, 2) and [2^125, 2^126) and at random points between (chip_smoke.py
    covers all of [1, 2^126))."""
    ends = [torch.arange(0x3F800000, 0x40000000, dtype=torch.int32),
            torch.arange(0x7E000000, 0x7E800000, dtype=torch.int32),
            torch.randint(0x3F800000, 0x7E800000, (1 << 22,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(0))]
    q = torch.cat(ends).to(cuda_device).view(torch.float32)
    want = torch.div(torch.ones_like(q), q)
    assert torch.equal(dense_kernel.warm_reciprocal(q).view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_warm_kernel_batch_matches_per_frame_launches_on_card(cuda_device):
    frames = [warm_inputs(WARM_CASES[i]) for i in (0, 0, 0)]
    kw = frames[0][3]
    stacked = [torch.stack([torch.as_tensor(f[0]) for f in frames]),
               torch.stack([torch.as_tensor(f[1]) for f in frames]),
               torch.stack([torch.as_tensor(f[2][0] + i) for i, f in enumerate(frames)]),
               torch.stack([torch.as_tensor(f[2][1] - i) for i, f in enumerate(frames)])]
    args = [t.to(cuda_device) for t in stacked]
    got = dense_kernel.dense_match_warm(*args, **kw)
    for i in range(len(frames)):
        one = dense_kernel.dense_match_warm(*(a[i] for a in args), **kw)
        assert all(torch.equal(g[i], o) for g, o in zip(got, one))


@pytest.mark.gpu
def test_batched_kernels_match_per_frame_launches_on_card(cuda_device):
    """One launch over a wave of two different inputs equals the plain
    version on the same stacked inputs (rows of all frames one after the
    other) and one launch per frame, slot by slot, for the support, stream
    and windowed kernels."""
    a, b, kw = support_inputs(SUPPORT_CASES[0])
    dl = torch.as_tensor(np.stack([a, b]), device=cuda_device)     # two different pairs
    dr = torch.as_tensor(np.stack([b, a]), device=cuda_device)
    out = support_kernel.support_match(dl, dr, **kw)
    plain = ref.support_match_rows_streaming(dl.flatten(0, 1), dr.flatten(0, 1), **kw)
    assert torch.equal(out, plain.reshape(out.shape))
    for i in range(2):
        assert torch.equal(out[i], support_kernel.support_match(dl[i].contiguous(),
                                                                dr[i].contiguous(), **kw))

    for make, cases, fn, plain_fn in (
        (dense_inputs, DENSE_CASES, dense_kernel.dense_match_stream,
         ref.dense_match_rows_stream_ref),
        (windowed_inputs, WINDOWED_CASES, dense_kernel.dense_match_candidates,
         ref.dense_match_rows_windowed_ref),
    ):
        pair = [make(cases[0]), make(cases[0][:-1] + (cases[0][-1] + 50,))]
        kw = pair[0][4]
        args = [torch.as_tensor(np.stack(x), device=cuda_device) for x in zip(
            *[(c[0], c[1], c[2][0], c[2][1], c[3][0], c[3][1]) for c in pair])]
        got = fn(*args, **kw)
        plain = plain_fn(*(t.flatten(0, 1) for t in args), **kw)
        assert all(torch.equal(g, w.reshape(g.shape)) for g, w in zip(got, plain))
        for i in range(2):
            one = fn(*(a[i].contiguous() for a in args), **kw)
            assert all(torch.equal(g[i], o) for g, o in zip(got, one))


@pytest.mark.gpu
def test_xla_exp_log_on_card_match_plain(cuda_device):
    """The kernels' float32 exp and log against the plain helpers over the
    energy's input ranges: x <= 0 for exp, [3, 4] for log."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = -88.5 * torch.rand(1 << 20, generator=gen)
    ex, _ = dense_kernel.xla_exp_log(x.to(cuda_device))
    assert torch.equal(ex.cpu(), ref.xla_exp_f32(x))
    y = 3.0 + torch.rand(1 << 20, generator=gen)
    _, lg = dense_kernel.xla_exp_log(y.to(cuda_device))
    assert torch.equal(lg.cpu(), ref.xla_log_f32(y))


def _at_offset(a: np.ndarray, offset: int, device) -> torch.Tensor:
    """``a`` on the card as a contiguous view starting ``offset`` bytes past
    an allocation's (aligned) start."""
    t = torch.as_tensor(a)
    raw = torch.empty(t.numel() * t.element_size() + offset, dtype=torch.uint8, device=device)
    view = raw[offset:].view(t.dtype).view(t.shape)
    view.copy_(t.to(device))
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 4, 7, 8, 12, 15])
def test_dense_kernels_take_unaligned_bitmasks_and_candidates_on_card(offset, cuda_device):
    """Bitmask rows at any byte offset and candidate windows at any 4-byte
    offset from a 16-byte boundary (a slot of a wave stack is such a view):
    the kernels' 16-byte staging equals the plain version."""
    dl, dr, mu, gm, kw = dense_inputs(DENSE_CASES[1])
    args = [torch.as_tensor(a, device=cuda_device) for a in (dl, dr, mu[0], mu[1])]
    masks = [_at_offset(g, offset, cuda_device) for g in gm]
    assert all(m.data_ptr() % 16 == offset for m in masks)
    got = dense_kernel.dense_match_stream(*args, *masks, **kw)
    want = ref.dense_match_rows_stream_ref(*args, *masks, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if offset % 4 == 0:
        dl, dr, mu, cand, kw = windowed_inputs(WINDOWED_CASES[3])
        args = [torch.as_tensor(a, device=cuda_device) for a in (dl, dr, mu[0], mu[1])]
        cands = [_at_offset(c, offset, cuda_device) for c in cand]
        got = dense_kernel.dense_match_candidates(*args, *cands, **kw)
        want = ref.dense_match_rows_windowed_ref(*args, *cands, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("sigma", [1.0, 2.0 ** -60, 1.5, 0.75])
def test_dense_kernels_match_plain_for_any_sigma_on_card(sigma, cuda_device):
    """2 sigma^2 a power of two (1.0, 2^-60: the kernels multiply by its
    reciprocal, which equals the division) and not one (1.5, 0.75: they
    divide): each kernel equals its plain version."""
    dl, dr, mu, gm, kw = dense_inputs(DENSE_CASES[0])
    kw = {**kw, "sigma": sigma}
    args = [torch.as_tensor(a, device=cuda_device) for a in (dl, dr, mu[0], mu[1], gm[0], gm[1])]
    got = dense_kernel.dense_match_stream(*args, **kw)
    want = ref.dense_match_rows_stream_ref(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dl, dr, mu, cand, kw = windowed_inputs(WINDOWED_CASES[0])
    kw = {**kw, "sigma": sigma}
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (dl, dr, mu[0], mu[1], cand[0], cand[1])]
    got = dense_kernel.dense_match_candidates(*args, **kw)
    want = ref.dense_match_rows_windowed_ref(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# Flash backward: the kernel's gradients (through ``_FlashFn``) against
# autograd through the plain version, on the same inputs and output gradient.
# Tolerance of each gradient: float32 within 2**-16 of its largest magnitude
# (sums in another order), bfloat16 within 4 bfloat16 steps of its largest
# magnitude's binade (both round float32 sums to bfloat16; the kernel's Delta
# reads the bf16-rounded output), as chip_smoke.py's FLASH_BWD_TOL.
FLASH_BWD_CASES = [
    # (B, H, Sq, Skv, D, causal, window, softcap, q scale)
    (1, 2, 200, 200, 16, True, 0, 0.0, 1.0),
    (2, 3, 257, 257, 64, False, 0, 0.0, 1.0),
    (1, 2, 130, 300, 128, False, 0, 0.0, 1.0),
    (1, 2, 300, 300, 128, True, 37, 0.0, 1.0),
    (1, 2, 300, 300, 32, True, 64, 50.0, 30.0),
    # The bfloat16 kernels' tiles are 128 own rows and 64 streamed rows: many
    # key and query tiles, a window crossing both tiles' edges, the softcap.
    (1, 2, 1024, 1024, 128, True, 0, 0.0, 1.0),
    (1, 2, 1024, 1024, 64, True, 200, 0.0, 1.0),
    (1, 2, 1024, 1024, 128, False, 0, 50.0, 30.0),
]


def _flash_bwd_inputs(case, dtype, device):
    b, h, sq, skv, d, _, _, _, q_scale = case
    gen = torch.Generator().manual_seed(sq + d)
    shapes = [(b, h, sq, d), (b, h, skv, d), (b, h, skv, d), (b, h, sq, d)]
    q, k, v, g = (torch.randn(s, generator=gen) for s in shapes)
    q = q * q_scale
    return [t.to(device, getattr(torch, dtype)) for t in (q, k, v, g)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_backward_matches_plain_on_card(case, dtype, cuda_device):
    from repro_torch.kernels import ref
    causal, window, cap = case[5:8]
    q, k, v, g = _flash_bwd_inputs(case, dtype, cuda_device)
    grads = []
    for fn in (flash_kernel.flash_attention, ref.flash_attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, causal=causal, window=window, softcap=cap).backward(g)
        grads.append([t.grad.float() for t in leaves])
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        top = float(want.abs().max())
        tol = (2.0 ** -16 * top if dtype == "float32"
               else 4 * 2.0 ** (math.floor(math.log2(top)) - 7))
        assert float((got - want).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_is_deterministic_on_card(dtype, cuda_device):
    """Two backward calls on the same inputs give the same bits (no atomics;
    the training replay relies on it)."""
    case = FLASH_BWD_CASES[-1]
    causal, window, cap = case[5:8]
    q, k, v, g = _flash_bwd_inputs(case, dtype, cuda_device)
    out, lse = flash_kernel._forward(q, k, v, causal, window, cap, with_lse=True)
    first, second = (flash_kernel.flash_attention_backward(q, k, v, out, lse, g, causal=causal,
                                                          window=window, softcap=cap)
                     for _ in range(2))
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    for a, b in zip(first, second):
        assert torch.equal(a.view(bits), b.view(bits))
