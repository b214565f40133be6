"""The dry run's tables (the JAX package's ``launch/report.py``): a
§Dry-run table of every cell and a §Roofline table per mesh, from the
JSON that ``python -m repro_torch.launch.dryrun --out`` writes.

    python -m repro_torch.launch.report dryrun_results.json

The formatting is the reference's; the fit column is the H100's 80 GB
(``analytic_memory``'s ``fits_80GB``), and the memory-bound notes speak
of the eager step the port traces."""
from __future__ import annotations

import json
import sys


def _f(x, nd=3):
    return f"{x:.{nd}f}" if isinstance(x, (int, float)) else str(x)


def _gib(b):
    return f"{b / 2**30:.2f}"


def _arch_label(r: dict) -> str:
    preset = r.get("preset", "2d")
    return r["arch"] if preset in (None, "2d") else \
        f"{r['arch']} [{preset}]"


def dryrun_table(results: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | compile_s | HLO GFLOP/dev | coll GB/dev "
        "| args MB/dev | analytic mem/dev GiB | fits 80GB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        if "skipped" in r:
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r.get('mesh','')} | — | — "
                f"| — | — | — | skipped: {r['skipped'][:40]} |")
            continue
        if "error" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                         f"| ERROR {r['error'][:60]} | | | | | |")
            continue
        cost = r.get("cost_corrected") or r.get("cost", {})
        coll = r.get("collectives_probe") or r.get("collectives", {})
        am = r.get("analytic_memory", {})
        mem = r.get("memory") or {}
        args_mb = (mem.get("argument_size_in_bytes", 0)) / 2**20
        lines.append(
            f"| {_arch_label(r)} | {r['shape']} | {r['mesh']} "
            f"| {r['compile_s']} "
            f"| {cost.get('flops', 0) / 1e9:.1f} "
            f"| {coll.get('wire_bytes', 0) / 1e9:.2f} "
            f"| {args_mb:.1f} "
            f"| {_gib(am.get('total_per_dev_B', 0))} "
            f"| {am.get('fits_80GB', '')} |")
    return "\n".join(lines)


def roofline_table(results: list[dict], mesh: str = "16x16") -> str:
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | bottleneck "
        "| MODEL_FLOPS (total) | useful ratio | what moves the bottleneck |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    notes = {
        ("memory", True): "eager byte count (every op's operands, no "
                          "fusion); fused attention would move this toward "
                          "compute",
        ("memory", False): "HBM-bound: larger per-device batch or better "
                           "fusion",
        ("compute", True): "compute-bound at high useful ratio: healthy",
        ("compute", False): "redundant compute: fix sharding (useful<1)",
        ("collective", True): "collective-bound: overlap or reshard",
        ("collective", False): "collective-bound: overlap or reshard",
    }
    for r in results:
        if r.get("mesh") != mesh or "roofline" not in r:
            continue
        t = r["roofline"]
        u = t.get("useful_flops_ratio")
        dom = t["bottleneck"]
        note = notes.get((dom, (u or 0) > 0.6), "")
        lines.append(
            f"| {_arch_label(r)} | {r['shape']} "
            f"| {_f(t['compute_s'], 4)} | {_f(t['memory_s'], 3)} "
            f"| {_f(t['collective_s'], 4)} | {dom} "
            f"| {t['model_flops_total']:.3g} "
            f"| {_f(u, 3) if u else '—'} | {note} |")
    return "\n".join(lines)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"
    with open(path) as fh:
        results = json.load(fh)
    print("## §Dry-run (all cells, both meshes)\n")
    print(dryrun_table(results))
    print("\n## §Roofline (single-pod 16x16)\n")
    print(roofline_table(results, "16x16"))
    print("\n### multi-pod 2x16x16 (shardability proof + scaling check)\n")
    print(roofline_table(results, "2x16x16"))


if __name__ == "__main__":
    main()
