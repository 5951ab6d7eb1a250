"""The port's roofline analysis (``repro_torch.analysis.roofline`` and
``report.py``) against the reference's (``repro.analysis.roofline``), for
all 10 architectures and their applicable shapes on both production meshes.

Equal (``rtol = 1e-12``: the same float operations in the same order): the
model FLOPs, the HBM bytes, and the compute and memory terms with the
reference's figures set to the H100's.  The two departures, each pinned:

- trip counts: the port's collective term times the reference's trip count
  (``microbatches x units`` in training, ``units`` in serving) is the
  reference's term;
- causal attention: on the architectures whose attention runs on the flash
  kernels, the executed FLOPs are the reference's with ``causal_skip`` on
  (and below its default's in training and prefill); on MLA's (plain
  PyTorch) they are the reference's default, the full grid.
"""
import dataclasses
import json

import pytest

from repro.analysis import roofline as ref_roofline
from repro.configs import get_config as ref_get_config
from repro_torch.analysis import report, roofline
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.models.config import LayerKind

CELLS = [(arch, shape) for arch in ARCH_IDS for shape in SHAPES
         if shape_applicable(get_config(arch), shape)]
MESHES = {"16x16": (256, ("data",)), "2x16x16": (512, ("pod", "data"))}
RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def memoised_reference_counts():
    """The reference counts parameters by tracing its model; once a config."""
    import functools

    import repro.models.model as ref_model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_model, "count_params",
                   functools.lru_cache(maxsize=None)(ref_model.count_params))
        yield


@pytest.fixture
def h100_reference(monkeypatch):
    """The reference's roofline with the port's H100 figures."""
    monkeypatch.setattr(ref_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(ref_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(ref_roofline, "ICI_BW", roofline.LINK_BW)
    return ref_roofline


def _on_flash(cfg) -> bool:
    return LayerKind.MLA not in cfg.layer_kinds


def _record(arch, shape, mesh, collectives):
    devices, batch = MESHES[mesh]
    return {"arch": arch, "shape": shape, "mesh": mesh, "devices": devices,
            "rules": {"batch": list(batch)}, "collectives": collectives, "flops": 1.0e12}


def test_figures_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 50e9)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_flops_and_bytes(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    got = roofline.analytic_flops(cfg, shape)
    want = ref_roofline.analytic_flops(ref_cfg, shape)
    skip = ref_roofline.analytic_flops(dataclasses.replace(ref_cfg, causal_skip=True), shape)
    assert got["model_flops"] == pytest.approx(want["model_flops"], rel=RTOL)
    executed = skip if _on_flash(cfg) else want
    assert got["executed_flops"] == pytest.approx(executed["executed_flops"], rel=RTOL)
    if _on_flash(cfg) and SHAPES[shape].mode != "decode" and any(
            k in (LayerKind.ATTN, LayerKind.ATTN_LOCAL) for k in cfg.layer_kinds):
        assert got["executed_flops"] < want["executed_flops"]
    for devices in (256, 512):
        for microbatches in (1, 8, 16):
            assert roofline.analytic_bytes(cfg, shape, devices, microbatches) == pytest.approx(
                ref_roofline.analytic_bytes(ref_cfg, shape, devices, microbatches), rel=RTOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_roofline_terms(h100_reference, arch, shape, mesh):
    cfg = get_config(arch)
    ref_cfg = dataclasses.replace(ref_get_config(arch), causal_skip=_on_flash(cfg))
    # Without collectives every term, the dominant one and the fractions agree.
    quiet = {"all-gather": 0, "all-reduce": 0, "count": 0}
    got = roofline.roofline_terms(_record(arch, shape, mesh, quiet), cfg)
    want = h100_reference.roofline_terms(_record(arch, shape, mesh, quiet), ref_cfg)
    for field in ("compute_s", "memory_s", "model_flops", "hlo_flops", "flops_ratio",
                  "roofline_fraction"):
        assert getattr(got, field) == pytest.approx(getattr(want, field), rel=RTOL), field
    assert got.collective_s == want.collective_s == 0.0 and got.dominant == want.dominant

    # With collectives: the port's whole-step bytes are not multiplied by a
    # trip count.
    busy = {"all-gather": 3_000_000_000, "all-reduce": 1_000_000, "reduce-scatter": 5,
            "count": 40}
    got = roofline.roofline_terms(_record(arch, shape, mesh, busy), cfg)
    want = h100_reference.roofline_terms(_record(arch, shape, mesh, busy), ref_cfg)
    devices = MESHES[mesh][0]
    assert got.collective_s == pytest.approx(3_001_000_005 / (devices * 50e9), rel=RTOL)
    micro = roofline._microbatches(_record(arch, shape, mesh, busy), shape)
    trip = micro * cfg.num_units if SHAPES[shape].mode == "train" else cfg.num_units
    assert got.collective_s * trip == pytest.approx(want.collective_s, rel=RTOL)


def test_report_reads_records(tmp_path, capsys):
    mesh_dir = tmp_path / "16x16"
    mesh_dir.mkdir()
    rec = _record("yi-9b", "decode_32k", "16x16", {"all-gather": 10, "count": 1})
    (mesh_dir / "yi-9b__decode_32k.json").write_text(json.dumps(rec))
    rows = report.build_table("16x16", str(tmp_path))
    assert [(r.arch, r.shape) for r in rows] == [("yi-9b", "decode_32k")]
    assert ("yi-9b", "decode_32k") not in report.missing_cells(rows)
    assert len(report.missing_cells(rows)) == len(CELLS) - 1
    report.main(["--results", str(tmp_path)])
    out = capsys.readouterr().out
    assert "| yi-9b | decode_32k | 16x16 |" in out and "not measured" in out
    assert "paper_representative" in out
