"""The port's parameters, configurations and synthetic data against the
reference package's: field for field, and byte for byte."""
import dataclasses

import numpy as np
import pytest

from repro.configs import elas_stereo as ref_cfg
from repro.core import params as ref_params
from repro.data.stereo import synthetic_stereo_pair as ref_pair
from repro_torch.configs import elas_stereo as port_cfg
from repro_torch.core import params as port_params
from repro_torch.data.stereo import synthetic_stereo_pair as port_pair

NAMED_PARAMS = ["FIG2_PARAMS", "PAPER_EVAL_PARAMS", "SYNTHETIC_BENCH_PARAMS"]


def test_param_fields_match_reference():
    ref = [(f.name, f.type, f.default) for f in dataclasses.fields(ref_params.ElasParams)]
    port = [(f.name, f.type, f.default) for f in dataclasses.fields(port_params.ElasParams)]
    assert port == ref


@pytest.mark.parametrize("name", NAMED_PARAMS)
def test_named_params_round_trip(name):
    ref = getattr(ref_params, name)
    port = getattr(port_params, name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    got = port_params.params_from_dict(dataclasses.asdict(ref))
    assert got == port and hash(got) == hash(port)
    assert got.num_disp == ref.num_disp
    assert got.num_candidates == ref.num_candidates
    for h, w in ((57, 83), (375, 1242), (480, 640)):
        assert got.grid_shape(h, w) == ref.grid_shape(h, w)


def test_params_frozen_and_strict():
    p = port_params.ElasParams()
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.disp_max = 1
    with pytest.raises(ValueError):
        port_params.params_from_dict({**dataclasses.asdict(p), "bogus": 1})
    d = dataclasses.asdict(p)
    del d["beta"]
    with pytest.raises(ValueError):
        port_params.params_from_dict(d)


@pytest.mark.parametrize("name", sorted(ref_cfg.STEREO_CONFIGS))
def test_configs_round_trip(name):
    ref = ref_cfg.STEREO_CONFIGS[name]
    port = port_cfg.STEREO_CONFIGS[name]
    got = port_cfg.config_from_dict(dataclasses.asdict(ref))
    assert got == port
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.params.num_disp == ref.params.num_disp
    assert got.params.grid_shape(got.height, got.width) == ref.params.grid_shape(
        ref.height, ref.width
    )


@pytest.mark.parametrize(
    "h,w,d_max,lighting,seed",
    [(57, 83, 24.0, "daylight", 11), (40, 64, 20.0, "lamps", 3), (31, 97, 48.0, "flashlight", 7)],
)
def test_synthetic_pair_bytes_match_reference(h, w, d_max, lighting, seed):
    ref = ref_pair(height=h, width=w, d_max=d_max, lighting=lighting, seed=seed)
    port = port_pair(height=h, width=w, d_max=d_max, lighting=lighting, seed=seed)
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert np.all(port[2] > 0)
