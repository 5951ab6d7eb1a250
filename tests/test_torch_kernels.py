"""The kernels' plain PyTorch versions against the reference's oracles and
Pallas kernels (interpret mode), on the inputs of ``torch_kernel_cases``.
Tolerance: exact (0 differing elements) everywhere.  The CUDA kernels are
held against these plain versions in ``test_torch_kernels_gpu.py``.
"""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tiling import WINDOWED_GATHERS
from repro.kernels import ops
from repro.kernels import ref as jref
from repro.kernels.dense_match import dense_match_pallas, dense_match_stream_pallas
from repro.kernels.median import median3x3_pallas
from repro.kernels.sobel import sobel_pallas
from repro.kernels.support_match import support_match_pallas
from repro_torch.kernels import dense_match as dense_kernel
from repro_torch.kernels import median as median_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import sobel as sobel_kernel
from repro_torch.kernels import support_match as support_kernel
from torch_kernel_cases import (
    DENSE_CASES,
    MEDIAN_CASES,
    SOBEL_CASES,
    SUPPORT_CASES,
    WINDOWED_CASES,
    dense_inputs,
    median_map,
    sobel_image,
    support_inputs,
    windowed_inputs,
)


@pytest.mark.parametrize("case", SUPPORT_CASES, ids=[c[0] for c in SUPPORT_CASES])
def test_support_plain_matches_reference(case):
    dl, dr, kw = support_inputs(case)
    got = ref.support_match_rows_streaming(torch.as_tensor(dl), torch.as_tensor(dr), **kw).numpy()
    oracle = np.asarray(jref.support_match_rows_ref(jnp.asarray(dl), jnp.asarray(dr), **kw))
    pallas = np.asarray(
        support_match_pallas(jnp.asarray(dl), jnp.asarray(dr), interpret=True, **kw)
    )
    mat = ref.support_match_rows_ref(torch.as_tensor(dl), torch.as_tensor(dr), **kw).numpy()
    assert got.shape == oracle.shape == (dl.shape[0], dl.shape[1] // 5)
    assert np.array_equal(got, oracle), "plain streaming vs the reference's materialised oracle"
    assert np.array_equal(got, pallas), "plain streaming vs support_match_pallas (interpret)"
    assert np.array_equal(mat, oracle), "port's materialised oracle vs the reference's"


def test_support_cases_exercise_both_outcomes():
    valid = 0
    for case in SUPPORT_CASES:
        dl, dr, kw = support_inputs(case)
        out = ref.support_match_rows_streaming(torch.as_tensor(dl), torch.as_tensor(dr), **kw)
        valid += int((out != -1.0).sum())
    assert valid > 0


@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_dense_plain_matches_pallas(case):
    dl, dr, mu, gm, kw = dense_inputs(case)
    got = ref.dense_match_rows_stream_ref(
        torch.as_tensor(dl), torch.as_tensor(dr), torch.as_tensor(mu[0]),
        torch.as_tensor(mu[1]), torch.as_tensor(gm[0]), torch.as_tensor(gm[1]), **kw,
    )
    want = dense_match_stream_pallas(
        jnp.asarray(dl), jnp.asarray(dr), jnp.asarray(mu[0]), jnp.asarray(mu[1]),
        jnp.asarray(gm[0]), jnp.asarray(gm[1]), interpret=True, precision="int8", **kw,
    )
    for g, x, view in zip(got, want, ("left", "right")):
        x = np.asarray(x)
        assert g.shape == x.shape and g.dtype == torch.float32
        diff = int(np.sum(g.numpy() != x))
        assert diff == 0, f"{view} view differs in {diff} pixels"


def test_wrappers_take_plain_version_on_cpu_without_counting():
    dl, dr, kw = support_inputs(SUPPORT_CASES[0])
    before = support_kernel.launches
    out = support_kernel.support_match(torch.as_tensor(dl), torch.as_tensor(dr), **kw)
    want = ref.support_match_rows_streaming(torch.as_tensor(dl), torch.as_tensor(dr), **kw)
    assert torch.equal(out, want) and support_kernel.launches == before

    dl, dr, mu, gm, kw = dense_inputs(DENSE_CASES[0])
    args = [torch.as_tensor(a) for a in (dl, dr, mu[0], mu[1], gm[0], gm[1])]
    before = dense_kernel.launches
    got = dense_kernel.dense_match_stream(*args, **kw)
    want = ref.dense_match_rows_stream_ref(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert dense_kernel.launches == before


def test_wrappers_reject_bad_inputs():
    dl, dr, kw = support_inputs(SUPPORT_CASES[0])
    tl, tr = torch.as_tensor(dl), torch.as_tensor(dr)
    with pytest.raises(TypeError):
        support_kernel.support_match(tl.to(torch.int32), tr.to(torch.int32), **kw)
    with pytest.raises(ValueError):
        support_kernel.support_match(tl, tr[:, :-1], **kw)
    with pytest.raises(ValueError):
        support_kernel.support_match(tl, tr, **{**kw, "offset": 5})

    dl, dr, mu, gm, kw = dense_inputs(DENSE_CASES[0])
    args = [torch.as_tensor(a) for a in (dl, dr, mu[0], mu[1], gm[0], gm[1])]
    with pytest.raises(ValueError):
        dense_kernel.dense_match_stream(*args, **{**kw, "num_disp": kw["num_disp"] + 1})
    with pytest.raises(TypeError):
        dense_kernel.dense_match_stream(*args[:2], args[2].double(), *args[3:], **kw)
    with pytest.raises(TypeError):
        dense_kernel.dense_match_stream(*args[:4], args[4].to(torch.uint8), args[5], **kw)
    with pytest.raises(ValueError):
        dense_kernel.dense_match_stream(*args, **{**kw, "disp_min": -1})


def test_support_wrapper_reads_strided_candidate_rows_on_cpu():
    """The candidate rows as a strided view of the descriptor maps (what
    core/support.py passes) give the grid the gathered rows give."""
    from repro_torch.core.support import candidate_rows

    rng = np.random.default_rng(3)
    maps = torch.as_tensor(rng.integers(-40, 41, (2, 2, 23, 37, 16)).astype(np.int8))
    _, _, kw = support_inputs(SUPPORT_CASES[0])
    step = kw["step"]
    vs = torch.arange(23 // step) * step + step // 2
    for dl, dr in ((maps[0, 0], maps[1, 0]), (maps[0], maps[1])):   # a frame, a wave
        rows_l, rows_r = candidate_rows(dl, step), candidate_rows(dr, step)
        assert not rows_l.is_contiguous()
        assert rows_l.data_ptr() == dl[..., step // 2, :, :].data_ptr()
        got = support_kernel.support_match(rows_l, rows_r, **kw)
        want = support_kernel.support_match(dl[..., vs, :, :].contiguous(),
                                            dr[..., vs, :, :].contiguous(), **kw)
        assert torch.equal(got, want)


def test_support_wrapper_limits_hold_on_cpu():
    """num_disp above SUPPORT_MAX_DISP, widths above SUPPORT_MAX_WIDTH and
    too many rows raise on the CPU as on the card; the disparity limit
    itself is taken."""
    dl, dr, kw = support_inputs(SUPPORT_CASES[5])
    tl, tr = torch.as_tensor(dl), torch.as_tensor(dr)
    top = support_kernel.SUPPORT_MAX_DISP
    out = support_kernel.support_match(tl, tr, **{**kw, "num_disp": top})
    want = ref.support_match_rows_streaming(tl, tr, **{**kw, "num_disp": 24})
    assert torch.equal(out, want)                   # every d past the width is off the image
    with pytest.raises(ValueError, match="num_disp <="):
        support_kernel.support_match(tl, tr, **{**kw, "num_disp": top + 1})
    zero = torch.zeros((1, 1, 16), dtype=torch.int8)
    wide = zero.expand(1, support_kernel.SUPPORT_MAX_WIDTH + 1, 16)
    with pytest.raises(ValueError, match="width"):
        support_kernel.support_match(wide, wide, **kw)
    tall = zero.expand(support_kernel.SUPPORT_MAX_ROWS + 1, 1, 16)
    with pytest.raises(ValueError, match="rows"):
        support_kernel.support_match(tall, tall, **kw)


def test_stream_wrapper_limits_hold_on_cpu():
    """num_disp above STREAM_MAX_DISP and widths above STREAM_MAX_WIDTH
    raise on the CPU as on the card; the limit itself is taken."""
    dl, dr, mu, _, kw = dense_inputs(DENSE_CASES[0])
    args = [torch.as_tensor(a) for a in (dl, dr, mu[0], mu[1])]
    h = dl.shape[0]
    for nd, ok in ((dense_kernel.STREAM_MAX_DISP, True), (dense_kernel.STREAM_MAX_DISP + 1, False)):
        gm = torch.zeros((h, 2, nd), dtype=torch.bool)
        call = functools.partial(dense_kernel.dense_match_stream, *args, gm, gm,
                                 **{**kw, "num_disp": nd})
        if ok:
            out = call()
            assert all(o.shape == (h, dl.shape[1]) for o in out)
        else:
            with pytest.raises(ValueError, match="num_disp <="):
                call()
    w = dense_kernel.STREAM_MAX_WIDTH + 1          # stride-0 views: no memory behind them
    desc = torch.zeros((1, 1, 16), dtype=torch.int8).expand(1, w, 16)
    mu_w = torch.zeros((1, 1)).expand(1, w)
    gm = torch.zeros((1, 1, kw["num_disp"]), dtype=torch.bool)
    with pytest.raises(ValueError, match="width"):
        dense_kernel.dense_match_stream(desc, desc, mu_w, mu_w, gm, gm, **kw)


# ---------------------------------------------------------------- XLA exp/log
def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


@pytest.mark.parametrize("fn,lo,hi,log_space", [
    ("exp", -87.0, 87.0, False),
    ("exp", -88.5, 0.0, False),          # the energy's exp argument, -(d - mu)^2 / 2
    ("log", -20.0, 20.0, True),
    ("log", 3.0, 4.0, False),            # the energy's log argument, gamma + exp(.)
])
def test_xla_exp_log_match_jitted_jax(fn, lo, hi, log_space):
    """The float32 helpers against XLA:CPU's own exp/log, bit for bit, on
    10^5 seeded samples (0 mismatches allowed)."""
    rng = np.random.default_rng(zlib.crc32(f"{fn} {lo} {hi}".encode()))
    x = rng.uniform(lo, hi, 100_000)
    x = (np.exp(x) if log_space else x).astype(np.float32)
    want = jax.jit(jnp.exp if fn == "exp" else jnp.log)(jnp.asarray(x))
    got = (ref.xla_exp_f32 if fn == "exp" else ref.xla_log_f32)(torch.as_tensor(x))
    assert got.dtype == torch.float32
    assert int(np.sum(_bits(got.numpy()) != _bits(want))) == 0


def test_dense_energy_matches_jitted_reference_expression():
    """The energy as the reference writes it (``beta * sad + prior``, which
    XLA:CPU fuses into an FMA) on 10^5 seeded (sad, d, mu) triples."""
    rng = np.random.default_rng(5)
    n = 100_000
    sad = rng.integers(0, 4081, n).astype(np.int32)
    d = rng.integers(0, 128, n).astype(np.float32)
    mu = rng.uniform(-5.0, 133.0, n).astype(np.float32)

    def energy(sad, d, mu):
        diff = d - mu
        prior = -jnp.log(3.0 + jnp.exp(-(diff * diff) / (2.0 * 1.0 * 1.0)))
        return 0.02 * sad.astype(jnp.float32) + prior

    want = jax.jit(energy)(jnp.asarray(sad), jnp.asarray(d), jnp.asarray(mu))
    got = ref.dense_energy(torch.as_tensor(sad), torch.as_tensor(d), torch.as_tensor(mu),
                           beta=0.02, gamma=3.0, two_s2=torch.tensor(2.0))
    assert int(np.sum(_bits(got.numpy()) != _bits(want))) == 0
    # XLA fuses the last multiply-add: rounding the product on its own differs.
    diff = torch.as_tensor(d) - torch.as_tensor(mu)
    prior = -ref.xla_log_f32(3.0 + ref.xla_exp_f32(-(diff * diff) / torch.tensor(2.0)))
    unfused = 0.02 * torch.as_tensor(sad).float() + prior
    assert int(np.sum(_bits(unfused.numpy()) != _bits(want))) > 0


def test_fma_f32_rounds_once():
    """A triple where rounding the float64 sum to float32 double-rounds:
    a * b + c = c + 2^-24 - 2^-70 lies just below the midpoint between c and
    its upper neighbour, so the FMA gives c; float64 rounding lands on the
    midpoint and ties-to-even would give the neighbour."""
    a = np.float32(2.0**-12 * (1 + 2.0**-23))
    b = np.float32(2.0**-12 * (1 - 2.0**-23))
    c = np.float32(1 + 2.0**-23)
    naive = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert naive != c                                       # the case is a real trap
    for sign in (1, -1):
        got = ref.fma_f32(torch.tensor(sign * a), torch.tensor(b), torch.tensor(sign * c))
        assert got.item() == sign * c


# ------------------------------------------------------------ candidate window
# The slice formulation sweeps only [disp_min, disp_min + D), the domain
# candidate_set clips values to (its docstring); windows that hold values
# outside it ("wide") are held against take and onehot, which take any int32.
WINDOWED_PARAMS = [
    pytest.param(case, gather, id=f"{case[0]}-{gather}")
    for case in WINDOWED_CASES for gather in WINDOWED_GATHERS
    if gather != "slice" or case[9] != "wide"
]


@pytest.mark.parametrize("case,gather", WINDOWED_PARAMS)
def test_windowed_plain_matches_pallas(case, gather):
    dl, dr, mu, cand, kw = windowed_inputs(case)
    got = ref.dense_match_rows_windowed_ref(
        torch.as_tensor(dl), torch.as_tensor(dr), torch.as_tensor(mu[0]),
        torch.as_tensor(mu[1]), torch.as_tensor(cand[0]), torch.as_tensor(cand[1]), **kw,
    )
    want = dense_match_pallas(
        jnp.asarray(dl), jnp.asarray(dr), jnp.asarray(mu[0]), jnp.asarray(mu[1]),
        jnp.asarray(cand[0]), jnp.asarray(cand[1]), interpret=True, gather_impl=gather,
        block_rows=2, **kw,
    )
    for g, x, view in zip(got, want, ("left", "right")):
        x = np.asarray(x)
        assert g.shape == x.shape and g.dtype == torch.float32
        diff = int(np.sum(g.numpy() != x))
        assert diff == 0, f"{view} view differs in {diff} pixels"


# ---------------------------------------------------------------- 3x3 stencils
@pytest.mark.parametrize("case", SOBEL_CASES, ids=[c[0] for c in SOBEL_CASES])
def test_sobel_plain_matches_pallas_and_reference(case):
    img = sobel_image(case)
    got = sobel_kernel.sobel(torch.as_tensor(img))
    pallas = sobel_pallas(jnp.asarray(img), interpret=True)
    oracle = ops.sobel(jnp.asarray(img), backend="ref")
    for g, x, y in zip(got, pallas, oracle):
        assert g.dtype == torch.int8 and g.shape == img.shape
        assert np.array_equal(g.numpy(), np.asarray(x)), "plain vs sobel_pallas (interpret)"
        assert np.array_equal(g.numpy(), np.asarray(y)), "plain vs ops.sobel(backend='ref')"


@pytest.mark.parametrize("case", MEDIAN_CASES, ids=[c[0] for c in MEDIAN_CASES])
def test_median_plain_matches_pallas(case):
    disp = median_map(case)
    got = median_kernel.median3x3(torch.as_tensor(disp))
    want = np.asarray(median3x3_pallas(jnp.asarray(disp), interpret=True))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy() == -1.0, disp == -1.0), "validity must pass through"


def test_stencils_take_a_batch():
    """A stack of images (both views, or a wave) gives each slice the result
    of that slice alone."""
    imgs = np.stack([sobel_image(c) for c in SOBEL_CASES[:1]] * 2)
    imgs[1] = 255 - imgs[1]
    gx, gy = sobel_kernel.sobel(torch.as_tensor(imgs))
    for i in range(2):
        one = sobel_kernel.sobel(torch.as_tensor(imgs[i]))
        assert torch.equal(gx[i], one[0]) and torch.equal(gy[i], one[1])
    maps = np.stack([median_map(MEDIAN_CASES[1]), median_map(MEDIAN_CASES[1])[::-1].copy()])
    out = median_kernel.median3x3(torch.as_tensor(maps))
    for i in range(2):
        assert torch.equal(out[i], median_kernel.median3x3(torch.as_tensor(maps[i])))


# ------------------------------------------------------------------- batching
def test_batched_wrappers_equal_per_frame_calls():
    """A leading batch axis on the support, stream and candidate-window
    wrappers: each slot equals the call on that frame alone."""
    a, b, kw = support_inputs(SUPPORT_CASES[0])
    dl = torch.as_tensor(np.stack([a, b]))                         # two different pairs
    dr = torch.as_tensor(np.stack([b, a]))
    out = support_kernel.support_match(dl, dr, **kw)
    assert out.shape == (2, dl.shape[1], dl.shape[2] // 5)
    for i in range(2):
        assert torch.equal(out[i], support_kernel.support_match(dl[i], dr[i], **kw))

    cases = [dense_inputs(DENSE_CASES[0]), dense_inputs(DENSE_CASES[0][:-1] + (9,))]
    kw = cases[0][4]
    args = [torch.as_tensor(np.stack(x)) for x in zip(
        *[(c[0], c[1], c[2][0], c[2][1], c[3][0], c[3][1]) for c in cases])]
    got = dense_kernel.dense_match_stream(*args, **kw)
    for i in range(2):
        one = dense_kernel.dense_match_stream(*(a[i] for a in args), **kw)
        assert all(torch.equal(g[i], o) for g, o in zip(got, one))

    cases = [windowed_inputs(WINDOWED_CASES[0]), windowed_inputs(WINDOWED_CASES[0][:-1] + (13,))]
    kw = cases[0][4]
    args = [torch.as_tensor(np.stack(x)) for x in zip(
        *[(c[0], c[1], c[2][0], c[2][1], c[3][0], c[3][1]) for c in cases])]
    got = dense_kernel.dense_match_candidates(*args, **kw)
    for i in range(2):
        one = dense_kernel.dense_match_candidates(*(a[i] for a in args), **kw)
        assert all(torch.equal(g[i], o) for g, o in zip(got, one))


def test_new_wrappers_take_plain_version_on_cpu_without_counting():
    before = (sobel_kernel.launches, median_kernel.launches, dense_kernel.windowed_launches)
    img = torch.as_tensor(sobel_image(SOBEL_CASES[0]))
    assert all(torch.equal(a, b) for a, b in zip(
        sobel_kernel.sobel(img), ref.sobel_rows_ref(*ref.edge_row_views(img.to(torch.int32)))))
    disp = torch.as_tensor(median_map(MEDIAN_CASES[0]))
    assert torch.equal(median_kernel.median3x3(disp),
                       ref.median3x3_rows_ref(*ref.edge_row_views(disp)))
    dl, dr, mu, cand, kw = windowed_inputs(WINDOWED_CASES[0])
    args = [torch.as_tensor(a) for a in (dl, dr, mu[0], mu[1], cand[0], cand[1])]
    got = dense_kernel.dense_match_candidates(*args, **kw)
    want = ref.dense_match_rows_windowed_ref(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (sobel_kernel.launches, median_kernel.launches,
            dense_kernel.windowed_launches) == before


def test_new_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        sobel_kernel.sobel(torch.zeros(5))
    with pytest.raises(TypeError):
        median_kernel.median3x3(torch.zeros((4, 4), dtype=torch.float64))
    dl, dr, mu, cand, kw = windowed_inputs(WINDOWED_CASES[0])
    args = [torch.as_tensor(a) for a in (dl, dr, mu[0], mu[1], cand[0], cand[1])]
    with pytest.raises(TypeError):
        dense_kernel.dense_match_candidates(*args[:4], args[4].long(), args[5].long(), **kw)
    with pytest.raises(ValueError):
        dense_kernel.dense_match_candidates(*args[:4], args[4][:, :-1], args[5], **kw)
    with pytest.raises(ValueError):
        dense_kernel.dense_match_candidates(*args, **{**kw, "disp_min": -1})
    with pytest.raises(ValueError):
        dense_kernel.xla_exp_log(torch.zeros(3))
