"""Merge dry-run result directories (later dirs override earlier) into a
final directory for reporting.

    PYTHONPATH=src python -m repro_torch.analysis.merge_results \
        results/dryrun_torch results/dryrun_torch_v2 \
        --out results/dryrun_torch_final

A copy of the JAX package's ``analysis/merge_results.py`` for the port's
records (``launch/dryrun``): the same files, the same overrides.
"""

from __future__ import annotations

import argparse
import os
import shutil


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    merged = {}
    for d in args.dirs:
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            if f.endswith(".json"):
                # pgbsc-opt replaces pgbsc in the final table
                target = f.replace("pgbsc-opt__", "pgbsc__")
                merged[target] = os.path.join(d, f)
    for target, src in merged.items():
        dst = os.path.join(args.out, target)
        if os.path.abspath(src) != os.path.abspath(dst):
            shutil.copyfile(src, dst)
    print(f"merged {len(merged)} records into {args.out}")


if __name__ == "__main__":
    main()
