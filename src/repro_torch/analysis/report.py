"""Roofline report: results/dryrun_torch/<mesh>/*.json -> markdown tables
(counterpart of ``repro/analysis/report.py``), with the cells of each mesh
that have no record.

  PYTHONPATH=src python -m repro_torch.analysis.report [--results DIR]
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

from repro_torch.analysis.roofline import RooflineResult, load_records, roofline_terms
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, shape_applicable

RESULTS = str(Path(__file__).resolve().parents[3] / "results" / "dryrun_torch")


def build_table(mesh: str = "16x16", results: str = RESULTS) -> list[RooflineResult]:
    records = load_records(os.path.join(results, mesh))
    return [roofline_terms(rec, get_config(rec["arch"]))
            for rec in sorted(records, key=lambda r: (r["arch"], r["shape"]))]


def markdown(results: list[RooflineResult]) -> str:
    lines = [
        "| arch | shape | mesh | compute ms | memory ms | collective ms (link model, "
        "not measured) | dominant | useful/executed | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        lines.append(r.as_row())
    return "\n".join(lines)


def pick_hillclimb_cells(results: list[RooflineResult]) -> dict:
    """worst roofline fraction / most collective-bound / most representative
    of the paper's technique (the MoE arch whose static capacity dispatch is
    the LM-side instance of the paper's irregular->regular move)."""
    worst = min(results, key=lambda r: r.roofline_fraction)
    coll = max(results, key=lambda r: r.collective_s / max(
        r.compute_s, r.memory_s, 1e-30))
    moe_cells = [r for r in results
                 if r.arch == "deepseek-v2-236b" and r.shape == "train_4k"]
    rep = moe_cells[0] if moe_cells else results[0]
    return {"worst_fraction": worst, "most_collective": coll,
            "paper_representative": rep}


def missing_cells(results: list[RooflineResult]) -> list[tuple[str, str]]:
    """The applicable (arch, shape) cells with no record."""
    have = {(r.arch, r.shape) for r in results}
    return [(arch, shape) for arch in ARCH_IDS for shape in SHAPES
            if shape_applicable(get_config(arch), shape) and (arch, shape) not in have]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS)
    args = ap.parse_args(argv)
    for mesh in ("16x16", "2x16x16"):
        if not os.path.isdir(os.path.join(args.results, mesh)):
            continue
        results = build_table(mesh, args.results)
        print(f"\n## Roofline table — mesh {mesh} ({len(results)} cells)\n")
        print(markdown(results))
        missing = missing_cells(results)
        print(f"\nNo record ({len(missing)}): "
              + (", ".join(f"{a} x {s}" for a, s in missing) or "none"))
        if mesh == "16x16" and results:
            picks = pick_hillclimb_cells(results)
            print("\n### Hillclimb picks")
            for k, r in picks.items():
                print(f"- {k}: {r.arch} x {r.shape} "
                      f"(dominant={r.dominant}, frac={r.roofline_fraction:.2f})")


if __name__ == "__main__":
    main()
