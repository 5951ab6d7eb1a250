"""The two properties the dense kernels' designs rest on, held against the
reference's oracles (``repro.kernels.ref``, jitted on the CPU) on the inputs
of ``torch_kernel_cases``.  Tolerance: exact (0 differing pixels).

* The stream route's result is the lexicographic (energy, d) minimum over
  each pixel's candidate set -- the cell's bitmask OR the prior band, AND
  the d whose matching column is in the image -- so a kernel may enumerate
  the set's members in ascending d instead of scanning every d.
* The candidate-window route's result does not change when each window is
  deduplicated and permuted, so a kernel may evaluate each distinct value
  once, in any order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import dense_match as dense_kernel
from repro_torch.kernels import ref
from torch_kernel_cases import DENSE_CASES, WINDOWED_CASES, dense_inputs, windowed_inputs


def _oracle(fn, dl, dr, mu, extra, kw):
    out = jax.jit(functools.partial(fn, **kw))(
        *(jnp.asarray(a) for a in (dl, dr, mu[0], mu[1], extra[0], extra[1])))
    return [np.asarray(o) for o in out]


def _energies(src, dst, mu, d, sign, kw):
    """(rows, W, n) float32 energies of one view's candidates ``d`` (rows, W,
    n), +inf where the matching column u + sign * d is off the image."""
    rows, w, _ = src.shape
    cols = np.arange(w)[:, None] + sign * d.astype(np.int64)
    gathered = dst[np.arange(rows)[:, None, None], np.clip(cols, 0, w - 1)]
    sad = np.abs(src[:, :, None, :].astype(np.int32) - gathered.astype(np.int32)).sum(-1)
    e = ref.dense_energy(torch.as_tensor(sad), torch.as_tensor(np.array(d, np.float32)),
                         torch.as_tensor(mu)[..., None], beta=kw["beta"], gamma=kw["gamma"],
                         two_s2=torch.tensor(2.0 * kw["sigma"] ** 2)).numpy()
    return np.where((cols >= 0) & (cols < w), e, np.inf)


def _lexmin(e, d, src, kw):
    """(the result, the number of valid pixels whose least energy two
    different candidates reach): the smallest d of least energy, or -1
    where that energy is not below BIGF or the texture is too low."""
    emin = e.min(axis=-1, keepdims=True)
    at_min = e == emin
    d = d.astype(np.int64)
    best = np.where(at_min, d, np.iinfo(np.int64).max).min(axis=-1)
    last = np.where(at_min, d, np.iinfo(np.int64).min).max(axis=-1)
    tex = np.abs(src.astype(np.int32)).sum(-1)
    valid = (emin[..., 0] < ref.BIGF) & (tex >= kw["match_texture"])
    return np.where(valid, best, -1).astype(np.float32), int((valid & (last > best)).sum())


def _stream_lexmin(case):
    """The lexicographic minimum over each pixel's candidate set, the set
    built from its definition with numpy; and the count of tied pixels."""
    dl, dr, mu, gm, kw = dense_inputs(case)
    rows, w, _ = dl.shape
    nd, dmin, radius = kw["num_disp"], kw["disp_min"], kw["plane_radius"]
    d = np.broadcast_to(dmin + np.arange(nd), (rows, w, nd))
    cx = np.minimum(np.arange(w) // kw["cell_px"], gm.shape[2] - 1)
    r = np.round(mu)[..., None]                                # half to even, like rint
    band = (d >= np.clip(r - radius, dmin, dmin + nd - 1)) & \
        (d <= np.clip(r + radius, dmin, dmin + nd - 1))
    want, ties = [], 0
    for view, (src, dst, sign) in enumerate(((dl, dr, -1), (dr, dl, 1))):
        e = _energies(src, dst, mu[view], d, sign, kw)
        e = np.where(gm[view][:, cx, :] | band[view], e, np.inf)
        out, tied = _lexmin(e, d, src, kw)
        want.append(out)
        ties += tied
    return (dl, dr, mu, gm, kw), want, ties


@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_stream_is_lexicographic_minimum_over_candidate_set(case):
    (dl, dr, mu, gm, kw), want, _ = _stream_lexmin(case)
    got = _oracle(jref.dense_match_rows_stream_ref, dl, dr, mu, gm, kw)
    for g, x, view in zip(got, want, ("left", "right")):
        assert int(np.sum(g != x)) == 0, f"{view} view"
    port = dense_kernel.dense_match_stream(
        *(torch.as_tensor(a) for a in (dl, dr, mu[0], mu[1], gm[0], gm[1])), **kw)
    assert all(np.array_equal(p.numpy(), x) for p, x in zip(port, want))


def _dedupe_permute(cand, w, rng):
    """Each window's distinct values in a random order, padded to C with
    w, a value whose matching column is off the image in both views."""
    out = np.full_like(cand, w)
    for idx in np.ndindex(cand.shape[:-1]):
        vals = np.unique(cand[idx])
        out[idx][: len(vals)] = vals
        out[idx] = rng.permutation(out[idx])
    return out


@pytest.mark.parametrize("case", WINDOWED_CASES, ids=[c[0] for c in WINDOWED_CASES])
def test_windowed_unchanged_by_dedupe_and_permutation(case):
    dl, dr, mu, cand, kw = windowed_inputs(case)
    moved = _dedupe_permute(cand, dl.shape[1], np.random.default_rng(case[-1]))
    assert not np.array_equal(np.sort(moved, axis=-1), np.sort(cand, axis=-1))
    want = _oracle(jref.dense_match_rows_windowed_ref, dl, dr, mu, cand, kw)
    got = _oracle(jref.dense_match_rows_windowed_ref, dl, dr, mu, moved, kw)
    for g, x, view in zip(got, want, ("left", "right")):
        assert int(np.sum(g != x)) == 0, f"{view} view"
    port = dense_kernel.dense_match_candidates(
        *(torch.as_tensor(a) for a in (dl, dr, mu[0], mu[1], moved[0], moved[1])), **kw)
    assert all(np.array_equal(p.numpy(), x) for p, x in zip(port, want))


def test_tie_cases_reach_ties():
    """The integer-prior cases on flat descriptors hold valid pixels whose
    least energy two candidates reach (d = mu -/+ k), so the smallest-d rule
    decides them, on both routes."""
    case = next(c for c in DENSE_CASES if c[0].startswith("tie-integer-prior"))
    (dl, dr, mu, gm, kw), want, ties = _stream_lexmin(case)
    assert ties > 0
    got = _oracle(jref.dense_match_rows_stream_ref, dl, dr, mu, gm, kw)
    assert all(np.array_equal(g, x) for g, x in zip(got, want))

    case = next(c for c in WINDOWED_CASES if c[0].startswith("tie-integer-prior"))
    dl, dr, mu, cand, kw = windowed_inputs(case)
    ties = 0
    want = []
    for view, (src, dst, sign) in enumerate(((dl, dr, -1), (dr, dl, 1))):
        out, tied = _lexmin(_energies(src, dst, mu[view], cand[view], sign, kw), cand[view],
                            src, kw)
        want.append(out)
        ties += tied
    assert ties > 0
    got = _oracle(jref.dense_match_rows_windowed_ref, dl, dr, mu, cand, kw)
    assert all(np.array_equal(g, x) for g, x in zip(got, want))
