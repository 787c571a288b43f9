"""One dry-run record's flops, bytes and collective bytes by op.

    PYTHONPATH=src python3 tools/dryrun_ops.py ARCH CELL MESH OUT.json

Traces the record ``python -m repro_torch.launch.dryrun --arch ARCH
--cell CELL --mesh MESH`` writes and sums its logged ops by name (count,
flops, bytes accessed, collective bytes) into ``OUT.json``, beside the
record's roofline terms and ``ran_whole``; prints the ops with flops,
largest first. Two torch versions' counts of one record compare op by
op.
"""

import json
import sys
from collections import defaultdict

from repro_torch.analysis import hlo
from repro_torch.launch import dryrun as dr


def main(argv=None) -> int:
    arch, cell, mesh, out = (argv or sys.argv[1:])[:4]
    got = []
    trace_step = hlo.trace_step

    def keep(*a, **k):
        res, tr = trace_step(*a, **k)
        got.append(tr)
        return res, tr
    hlo.trace_step = keep
    try:
        rec = dr.run_cell(arch, cell, mesh)
    finally:
        hlo.trace_step = trace_step
    by = defaultdict(lambda: [0, 0, 0, 0])
    for r in got[-1].ops:
        b = by[r.name]
        b[0] += 1
        b[1] += r.flops
        b[2] += r.bytes
        b[3] += r.collective_bytes
    with open(out, "w") as f:
        json.dump({"record": rec["roofline"], "ran_whole": rec["ran_whole"],
                   "by_op": dict(by)}, f, indent=1)
    print(arch, cell, mesh, f"flops {rec['roofline']['flops']:.6e}",
          sorted(((v[1], k) for k, v in by.items() if v[1]), reverse=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
