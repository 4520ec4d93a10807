"""Generate the dry-run and roofline tables (markdown) from the JSON
records ``launch/dryrun.py`` writes.  The figures are a model of H100
cards from datasheet peaks (``roofline/analysis.py``), not measurements.

  PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun.json
"""
from __future__ import annotations

import json
import sys

# The memory column's capacity: one NVIDIA H100 80GB HBM3 (launch/dryrun.py).
HBM_LABEL = "80GB"


def gib(b):
    return f"{b/2**30:.2f}"


def fmt_sci(x):
    return f"{x:.2e}" if x else "-"


def dryrun_table(results) -> str:
    lines = [
        f"| arch | shape | mesh | compile s | mb | arg GiB | temp GiB | fits {HBM_LABEL} | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(results, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r.get("error"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | - | - | - | "
                f"ERROR | {r['error'][:60]} |"
            )
            continue
        if not r.get("supported", True):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | - | - | - | "
                f"skip | {r.get('skip_reason','')[:70]} |"
            )
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('compile_s','-')} |"
            f" {r.get('microbatches','-')} | {gib(r.get('arg_bytes',0))} |"
            f" {gib(r.get('temp_bytes',0))} | {'yes' if r.get('fits_hbm') else 'NO'} | |"
        )
    return "\n".join(lines)


def roofline_table(results, mesh="single") -> str:
    lines = [
        "| arch | shape | t_comp s | t_mem s | t_coll s | bottleneck | "
        "MODEL/HLO flops | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(results, key=lambda r: (r["arch"], r["shape"])):
        if r.get("mesh") != mesh or r.get("error") or not r.get("supported", True):
            continue
        if "t_compute_s" not in r:
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3f} |"
            f" {r['t_memory_s']:.3f} | {r['t_collective_s']:.3f} |"
            f" {r['bottleneck']} | {r.get('useful_compute_ratio',0):.2f} |"
            f" {r.get('roofline_fraction',0):.3f} |"
        )
    return "\n".join(lines)


def summarize(results):
    ok = [r for r in results if r.get("supported", True) and not r.get("error")]
    skip = [r for r in results if not r.get("supported", True)]
    err = [r for r in results if r.get("error")]
    fits = [r for r in ok if r.get("fits_hbm")]
    return (
        f"cells compiled: {len(ok)}; documented skips: {len(skip)}; "
        f"errors: {len(err)}; fit {HBM_LABEL}/card: {len(fits)}/{len(ok)}"
    )


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun.json"
    with open(path) as f:
        results = json.load(f)
    print("## Summary\n")
    print(summarize(results))
    print("\n## Dry-run table\n")
    print(dryrun_table(results))
    print("\n## Roofline (single-pod)\n")
    print(roofline_table(results, "single"))
    print("\n## Roofline (multi-pod)\n")
    print(roofline_table(results, "multi"))


if __name__ == "__main__":
    main()
