"""Full-size frames of the paper's two settings (synthetic scenes, seed 0),
held against the reference's ``ielas_disparity``.  Each scene has a test
file of its own (tests/test_torch_fullframe_kitti.py, _tsukuba.py), so
that ``--dist loadfile`` can give the two long cases to different workers.

The port evaluates the dense energy's exp/log with XLA:CPU's own float32
polynomials (kernels/ref.py::xla_exp_f32, xla_log_f32), so near-ties
resolve as in the reference.  The counts are pinned, not bounded: ROADMAP.md
queue 3 records them (Tsukuba was 5 with correctly rounded exp/log)."""
import dataclasses

import jax.numpy as jnp
import numpy as np

from repro.configs.elas_stereo import KITTI as REF_KITTI
from repro.configs.elas_stereo import TSUKUBA as REF_TSUKUBA
from repro.core import pipeline as ref_pipeline
from repro.data.stereo import synthetic_stereo_pair
from repro_torch.core import pipeline
from repro_torch.core.params import params_from_dict

KITTI_FRAME = (REF_KITTI, 100.0, 0)        # 375 x 1242, D = 128
TSUKUBA_FRAME = (REF_TSUKUBA, 48.0, 0)     # 480 x 640, D = 64


def frame_id(v):
    return getattr(v, "name", v)


def check_full_size_frame(cfg, d_max, mismatches):
    il, ir, _ = synthetic_stereo_pair(height=cfg.height, width=cfg.width, d_max=d_max, seed=0)
    want = np.asarray(ref_pipeline.ielas_disparity(
        jnp.asarray(il, jnp.float32), jnp.asarray(ir, jnp.float32), cfg.params, backend="ref",
    ))
    got = pipeline.ielas_disparity(il, ir, params_from_dict(dataclasses.asdict(cfg.params)),
                                   device="cpu").numpy()
    assert int(np.sum(got != want)) == mismatches
