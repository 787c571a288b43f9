"""Aggregate the port's dry-run JSONs (``launch/dryrun``) into roofline
and memory tables.

    PYTHONPATH=src python -m repro_torch.analysis.report results/dryrun_torch

A copy of the JAX package's ``analysis/report.py``: the same tables and
headings (the mesh shapes: 16x16 = 256 ranks, 2x16x16 = 512), read from
the port's records, each rank's terms over the peaks the record names
(``peaks``; the H100's data sheet by default). :func:`bottleneck_note`
names the port's remedies.
"""

from __future__ import annotations

import json
import os
import sys


def load(outdir: str) -> list[dict]:
    recs = []
    for f in sorted(os.listdir(outdir)):
        if f.endswith(".json"):
            with open(os.path.join(outdir, f)) as fh:
                recs.append(json.load(fh))
    return recs


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b / 2**30:.2f}GiB"


def bottleneck_note(r: dict) -> str:
    """One sentence: what would move the dominant term down."""
    dom = r["roofline"]["dominant"]
    arch, cell = r["arch"], r["cell"]
    if arch == "pgbsc":
        if dom == "memory":
            return ("bf16/int compressed count tables or fewer table "
                    "streams via deeper sub-template dedup/partition search")
        return "reduce eMA child all-gathers via per-node gather-vs-"\
               "reduce-scatter cost model"
    if dom == "compute":
        return "lower capacity factor / expert-choice routing (MoE) or "\
               "fp8 matmuls"
    if dom == "collective":
        if "ogb" in cell or "minibatch" in cell:
            return ("graph partitioning (METIS-style) to localize edges and "
                    "cut cross-shard scatter-reduce volume")
        if "decode" in cell or "500k" in cell:
            return "kv-cache quantization (int8) halves gather payloads"
        return "overlap collectives with compute (async all-gather) or "\
               "int8-compressed gradient reduction"
    # memory
    if "train" in cell:
        return "more microbatches / bf16 master-grad accumulation to cut "\
               "activation traffic"
    if "decode" in cell or "500k" in cell:
        return "int8/int4 KV-cache quantization (2-4x cache-read bytes)"
    if arch == "autoint":
        return "fuse embedding-bag gathers with the interaction matmul "\
               "(single pass over field embeddings)"
    return "operator fusion to keep intermediates in registers/shared "\
           "memory (a hand-written CUDA kernel for the hot loop)"


def roofline_table(recs: list[dict], mesh: str = "single") -> str:
    rows = ["| arch | cell | flops/dev | bytes/dev | coll bytes | compute s "
            "| memory s | coll s | dominant | useful ratio | to improve |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if not r.get("ok"):
            rows.append(f"| {r['arch']} | {r['cell']} | FAILED: "
                        f"{r.get('error', '?')[:60]} | | | | | | | | |")
            continue
        rf = r["roofline"]
        ur = r.get("useful_flops_ratio")
        ur_s = f"{ur:.2f}" if ur is not None else "-"
        rows.append(
            f"| {r['arch']} | {r['cell']} | {rf['flops']:.3g} "
            f"| {rf['bytes']:.3g} | {rf['collective_bytes']:.3g} "
            f"| {rf['compute_s']:.4g} | {rf['memory_s']:.4g} "
            f"| {rf['collective_s']:.4g} | **{rf['dominant']}** "
            f"| {ur_s} | {bottleneck_note(r)} |")
    return "\n".join(rows)


def memory_table(recs: list[dict], mesh: str = "single") -> str:
    rows = ["| arch | cell | args/dev | output/dev | temp/dev | compile s |",
            "|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh or not r.get("ok"):
            continue
        m = r["memory"]
        rows.append(
            f"| {r['arch']} | {r['cell']} | {fmt_bytes(m['argument_bytes'])} "
            f"| {fmt_bytes(m['output_bytes'])} | {fmt_bytes(m['temp_bytes'])} "
            f"| {r['compile_s']} |")
    return "\n".join(rows)


def summary(recs: list[dict]) -> str:
    ok = [r for r in recs if r.get("ok")]
    fail = [r for r in recs if not r.get("ok")]
    lines = [f"total records: {len(recs)}  ok: {len(ok)}  failed: "
             f"{len(fail)}"]
    for r in fail:
        lines.append(f"  FAIL {r['arch']}/{r['cell']}/{r['mesh']}: "
                     f"{r.get('error', '')[:120]}")
    return "\n".join(lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    outdir = argv[0] if argv else "results/dryrun_torch"
    recs = load(outdir)
    print(summary(recs))
    print("\n## Roofline — single-pod 16x16 (256 ranks)\n")
    print(roofline_table(recs, "single"))
    print("\n## Roofline — multi-pod 2x16x16 (512 ranks)\n")
    print(roofline_table(recs, "multi"))
    print("\n## Memory analysis (single-pod)\n")
    print(memory_table(recs, "single"))


if __name__ == "__main__":
    main()
