"""One training step under a DeviceMesh on the CPU (the world-1 ``gloo``
group and (1, 1) mesh of ``tests/torch_mesh_cases.py``): ``Trainer`` with
the parameters and AdamW moments laid out by ``shard_model`` and the rules
of ``make_rules``, for yi-9b and deepseek-v2-lite-16b (and, in
``tests/test_torch_mesh_train_jamba.py``, jamba-1.5-large-398b) reduced, in
float32, two microbatches (``torch_mesh_cases.check_trainer_step``).

Under the mesh the step's metrics, parameters and moments are bit-equal to
the same step without it, and held to the reference's jitted step
(``make_train_step``, run under its one-device mesh with its rules) from the
same weights and batch: ce, the loss, the gradient norm and the rate within
``tests/test_torch_train.py``'s rtol 1e-5, and the first moment (0.1 times
the clipped gradient after a first step) within
``tests/test_torch_gradients.py``'s 1e-5 of each tensor's largest magnitude.
The parameters are not compared with the reference's after a first step:
from zero moments AdamW moves each weight by the rate times the sign of its
gradient, so a gradient near zero whose last bits differ moves it by up to
twice the rate (1.3e-5 seen on one of deepseek's weights; the parameters
are held after steps from a carried state in ``tests/test_torch_train.py``).
"""
import pytest

from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_mesh_cases import check_trainer_step, mesh  # noqa: F401 (a fixture)


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-lite-16b"])
def test_trainer_step_under_the_mesh(mesh, arch, tmp_path):
    check_trainer_step(mesh, arch, tmp_path)
