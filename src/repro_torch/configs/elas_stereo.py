"""iELAS stereo configs for the paper's two evaluation settings
(copy of ``repro/configs/elas_stereo.py``).

The paper evaluates on New Tsukuba (640x480) and KITTI (1242x375); the
interpolation parameters follow Table III's caption (s_delta = 50 px =
10 grid nodes, epsilon = 15, C = 60).  SYNTH is the tuned setting for the
procedurally generated benchmark scenes (see repro_torch.data.stereo).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.core.params import ElasParams, params_from_dict


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    name: str
    height: int
    width: int
    params: ElasParams


TSUKUBA = StereoConfig(
    name="elas-tsukuba",
    height=480,
    width=640,
    params=ElasParams(disp_max=63, s_delta=10, epsilon=15.0, const_fill=60.0),
)

KITTI = StereoConfig(
    name="elas-kitti",
    height=375,
    width=1242,
    params=ElasParams(disp_max=127, s_delta=10, epsilon=15.0, const_fill=60.0),
)

SYNTH = StereoConfig(
    name="elas-synth",
    height=240,
    width=320,
    params=ElasParams(disp_max=63, s_delta=32, epsilon=15.0, const_fill=16.0),
)

STEREO_CONFIGS = {c.name: c for c in (TSUKUBA, KITTI, SYNTH)}


def config_from_dict(d: Mapping[str, Any]) -> StereoConfig:
    """Build :class:`StereoConfig` from ``dataclasses.asdict`` of an
    equivalent object (its ``params`` entry is itself a dict)."""
    d = dict(d)
    d["params"] = params_from_dict(d["params"])
    return StereoConfig(**d)
