"""The port stands alone: nothing under src/repro_torch/, in chip_smoke.py,
dense_profile.py, flash_profile.py, stage_profile.py, service_profile.py,
lm_step_profile.py, meshless_cost.py or the port's five examples
(examples/torch_*.py) imports jax or the reference package, and importing
the port loads no jax."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "dense_profile.py", ROOT / "flash_profile.py",
    ROOT / "stage_profile.py", ROOT / "service_profile.py", ROOT / "lm_step_profile.py",
    ROOT / "meshless_cost.py",
] + [ROOT / "examples" / f"torch_{name}.py" for name in (
    "quickstart", "stereo_serving", "lm_serving", "train_lm", "fault_tolerance_demo")]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
            node.func, "attr", getattr(node.func, "id", "")
        ) in ("import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    roots.add(arg.value.split(".")[0])
    return roots


def test_port_files_found():
    assert len(PORT_FILES) > 10
    for name in ("support_match", "dense_match_stream", "dense_match_windowed",
                 "dense_match_warm", "sobel", "median", "flash_attention",
                 "flash_attention_bwd"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu").exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_lm_model_leaves_the_stereo_stack_unloaded():
    """The LM model needs only the flash kernel and the device helper, not
    the stereo pipeline (nor scipy, which its triangulation loads)."""
    code = (
        "import sys\n"
        "import repro_torch.models\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('repro_torch.core', "
        "'repro_torch.serving', 'scipy')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import repro_torch.core.pipeline, repro_torch.core.triangulation, "
        "repro_torch.kernels.support_match, "
        "repro_torch.kernels.dense_match, repro_torch.kernels.sobel, "
        "repro_torch.kernels.median, repro_torch.kernels.flash_attention, "
        "repro_torch.core.tiling, repro_torch.configs.elas_stereo, repro_torch.data.stereo, "
        "repro_torch.runtime.fault_tolerance, repro_torch.serving, "
        "repro_torch.serving.stereo_service, repro_torch.serving.warmstart, "
        "repro_torch.launch.serve, repro_torch.configs, repro_torch.models, "
        "repro_torch.models.model, repro_torch.models.attention, repro_torch.models.mlp, "
        "repro_torch.models.common, repro_torch.serving.engine, repro_torch.device, "
        "repro_torch.configs.gemma2_27b, repro_torch.models.mla, repro_torch.models.moe, "
        "repro_torch.configs.deepseek_v2_lite_16b, repro_torch.configs.deepseek_v2_236b, "
        "repro_torch.models.mamba, repro_torch.configs.jamba_1_5_large_398b, "
        "repro_torch.models.xlstm, repro_torch.configs.xlstm_350m, "
        "repro_torch.configs.qwen2_vl_7b, repro_torch.configs.musicgen_large, "
        "repro_torch.data.tokens, repro_torch.optim.adamw, repro_torch.optim.schedule, "
        "repro_torch.optim.compression, repro_torch.runtime.train_loop, "
        "repro_torch.runtime.checkpoint, repro_torch.launch.train, repro_torch.distributed, "
        "repro_torch.distributed.sharding, repro_torch.launch.mesh, repro_torch.configs.shapes, "
        "repro_torch.analysis, repro_torch.analysis.roofline\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
