"""Each CUDA kernel of the port against its plain PyTorch version (tests
marked ``gpu``: they skip without a card), and the ctypes bindings against
the C launchers' signatures (runs everywhere).  Imports no JAX, so it runs
on a machine with a card and without JAX:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import ctypes
import re

import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import dense_match as dense_kernel
from repro_torch.kernels import support_match as support_kernel
from torch_kernel_cases import DENSE_CASES, SUPPORT_CASES, dense_inputs, support_inputs

_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("source,symbol,module", [
    ("support_match", "ielas_support_match", support_kernel),
    ("dense_match_stream", "ielas_dense_match_stream", dense_kernel),
])
def test_binding_matches_launcher_signature(source, symbol, module):
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, f"no extern C launcher {symbol} in csrc/{source}.cu"
    params = [" ".join(p.split()[:-1]).replace("const ", "").replace(" *", "*")
              for p in m.group(1).split(",")]
    assert [_C_TYPES[p] for p in params] == module.ARGTYPES
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
