"""``tests/test_torch_mesh_train.py``'s training step under a DeviceMesh
for jamba-1.5-large-398b reduced (Mamba, MoE, one attention layer in eight),
in a file of its own: its reference step alone compiles for ~20 s.
"""
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_mesh_cases import check_trainer_step, mesh  # noqa: F401 (a fixture)


def test_trainer_step_under_the_mesh(mesh, tmp_path):
    check_trainer_step(mesh, "jamba-1.5-large-398b", tmp_path)
