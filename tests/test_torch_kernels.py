"""The kernels' plain PyTorch versions against the reference's oracles and
Pallas kernels (interpret mode), on the inputs of ``torch_kernel_cases``.
Tolerance: exact (0 differing elements) everywhere.  The CUDA kernels are
held against these plain versions in ``test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.dense_match import dense_match_stream_pallas
from repro.kernels.support_match import support_match_pallas
from repro_torch.kernels import dense_match as dense_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import support_match as support_kernel
from torch_kernel_cases import (
    DENSE_CASES,
    SUPPORT_CASES,
    dense_inputs,
    support_inputs,
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
