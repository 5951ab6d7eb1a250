"""The facts the support kernel's design relies on (csrc/support_match.cu),
proved on the plain side: its packed keys, kept as the two least of each
class of d mod 4, folded in any order or over split d ranges and merged,
give the (best, min1, min2) that ``_finalize4`` gives from the registers
``_insert4`` keeps when it folds the whole range in ascending d.  Exact
comparisons throughout."""
import numpy as np
import torch

from hypothesis_compat import given, settings, st
from repro_torch.kernels import ref


def _fold_insert4(costs: torch.Tensor):
    """The plain registers' result: strict-< inserts over ascending d."""
    regs = ref._init4(costs.shape[:1], costs.device)
    for d in range(costs.shape[1]):
        regs = ref._insert4(*regs, costs[:, d], d)
    return ref._finalize4(*regs)


def _fold_keys(costs: torch.Tensor, ds) -> torch.Tensor:
    keys = ref.keys_fill(costs.shape[:1])
    for d in ds:
        keys = ref.keys_insert(keys, ref.support_key(costs[:, d], d), int(d))
    return keys


def _costs(seed: int, n: int, nd: int, levels: int, out_share: float) -> torch.Tensor:
    """(n, nd) costs from few levels (many ties), BIG where out of the image."""
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, levels, (n, nd)) * (4080 // max(levels - 1, 1))
    costs[rng.random((n, nd)) < out_share] = ref.BIG
    return torch.as_tensor(costs.astype(np.int32))


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), nd=st.integers(1, 100), levels=st.integers(1, 8),
       out_share=st.sampled_from([0.0, 0.3, 0.9, 1.0]))
def test_keys_in_any_order_equal_insert4(seed, nd, levels, out_share):
    """The classes' result is _finalize4's, whether the keys come in
    ascending d or shuffled."""
    costs = _costs(seed, 16, nd, levels, out_share)
    want = _fold_insert4(costs)
    assert _equal(ref.keys_finalize(_fold_keys(costs, range(nd))), want)
    order = np.random.default_rng(seed + 1).permutation(nd)
    assert _equal(ref.keys_finalize(_fold_keys(costs, order)), want)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), nd=st.integers(1, 130), levels=st.integers(1, 8),
       chunk=st.sampled_from([1, 3, 8, 32]), out_share=st.sampled_from([0.0, 0.5]))
def test_split_ranges_merge_to_insert4(seed, nd, levels, chunk, out_share):
    """d split into chunks, each folded alone, merged pairwise in a random
    order (the kernel's lane butterfly is one such order): _finalize4's
    (best, min1, min2)."""
    costs = _costs(seed, 16, nd, levels, out_share)
    parts = [_fold_keys(costs, range(d0, min(d0 + chunk, nd))) for d0 in range(0, nd, chunk)]
    rng = np.random.default_rng(seed + 2)
    while len(parts) > 1:
        i, j = sorted(rng.choice(len(parts), 2, replace=False))
        parts[i] = ref.keys_merge(parts[i], parts.pop(j))
    assert _equal(ref.keys_finalize(parts[0]), _fold_insert4(costs))


def test_ties_keep_the_smallest_d_across_a_split():
    """Equal least costs at d = 31 and 32, folded in separate chunks: best
    is d = 31, as ascending strict-< inserts keep it, and min2 skips 32."""
    costs = torch.full((1, 64), 100, dtype=torch.int32)
    costs[0, 31] = costs[0, 32] = 5
    lo, hi = _fold_keys(costs, range(32)), _fold_keys(costs, range(32, 64))
    for keys in (ref.keys_merge(lo, hi), ref.keys_merge(hi, lo)):
        best, min1, min2 = ref.keys_finalize(keys)
        assert (int(best), int(min1), int(min2)) == (31, 5, 100)
    assert _equal(ref.keys_finalize(ref.keys_merge(lo, hi)), _fold_insert4(costs))


def test_second_of_a_class_when_its_least_lies_next_to_best():
    """min2 comes from a class's second key when its least is best +- 1:
    costs 1 at d = 8 (best), 2 at d = 9 (inside), 3 at d = 13 (class of 9,
    outside), 4 elsewhere."""
    costs = torch.full((1, 20), 4, dtype=torch.int32)
    costs[0, 8], costs[0, 9], costs[0, 13] = 1, 2, 3
    best, min1, min2 = ref.keys_finalize(_fold_keys(costs, range(20)))
    assert (int(best), int(min1), int(min2)) == (8, 1, 3)
    assert _equal((best, min1, min2), _fold_insert4(costs))


def test_empty_registers_decode_to_big_at_zero():
    """No in-image d: every register is KEY_FILL, which decodes to best 0
    and min1 = min2 = BIG, the plain registers' start."""
    costs = torch.full((3, 10), ref.BIG, dtype=torch.int32)
    keys = _fold_keys(costs, range(10))
    assert bool((keys == ref.KEY_FILL).all())
    best, min1, min2 = ref.keys_finalize(keys)
    assert bool((best == 0).all() and (min1 == ref.BIG).all() and (min2 == ref.BIG).all())
    assert _equal((best, min1, min2), _fold_insert4(costs))


def test_key_bounds():
    """The largest key of an in-image pair (cost 4080, d 1023) stays below
    KEY_FILL and keeps its order: cost in the high bits, d in the low 10."""
    top = ref.support_key(torch.tensor([4080], dtype=torch.int32), 1023)
    assert int(top) == (4080 << 10) + 1023 < ref.KEY_FILL
    a = ref.support_key(torch.tensor([7], dtype=torch.int32), 1023)
    b = ref.support_key(torch.tensor([8], dtype=torch.int32), 0)
    assert int(a) < int(b)
