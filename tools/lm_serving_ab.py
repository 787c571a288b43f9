"""Time ``chip_smoke.py``'s (L3) bf16 serving of the three dense LMs
(smollm-360m, llama3-8b, gemma3-1b; batch 8, 2,048-token prompts, 32
decode steps) from two trees on one card, in turns:

    python3 tools/lm_serving_ab.py <tree A> <tree B>

runs A, B, B, A, each in a process of its own that imports that tree's
``chip_smoke.py`` and ``src/`` (unpack the other tree with ``git archive``
into a directory ``.gitignore`` lists). Prints each run's ``[lm] L3``
lines.
"""

import subprocess
import sys
from pathlib import Path

_RUN = r'''
import sys, time
tree = sys.argv[1]
sys.path.insert(0, tree)
sys.path.insert(0, tree + "/src")
import torch
import chip_smoke as cs
assert cs.__file__.startswith(tree), cs.__file__
torch.backends.cuda.matmul.allow_tf32 = False
cs.LM_IDS = ("smollm-360m", "llama3-8b", "gemma3-1b")
cs._profile = lambda label, fn, cpu=True: fn()
t0 = time.perf_counter()
cs.phase_lm_serving()
print(f"[ab] tree {tree} took {time.perf_counter() - t0:.1f} s", flush=True)
'''


def main(argv=None) -> int:
    a, b = (str(Path(t).resolve()) for t in (argv or sys.argv[1:3]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in (a, b, b, a):
        print(f"[ab] tree {tree}", flush=True)
        out = subprocess.run([sys.executable, "-c", _RUN, tree],
                             capture_output=True, text=True)
        for line in out.stdout.splitlines():
            if line.startswith(("[ab]", "[lm] L3")):
                print(line, flush=True)
        if out.returncode:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
