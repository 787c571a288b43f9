"""Run phases (L), (T) and (Y) of ``chip_smoke.py`` alone on one card.

    python3 tools/chip_phases.py [L] [T] [Y]

(L) serves the LMs and AutoInt (L0-L3, without L4), (T) trains (T0-T4);
neither needs the CUDA kernels built. (Y) builds them, then runs the dry
run against the card (Y1 on ``grid_2d(1024, 1024)``, Y2; Y3 when (T) ran
first, beside T1's peak). All print ``chip_smoke.py``'s own lines; TF32
is off, as there.
"""

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    which = (argv if argv is not None else sys.argv[1:]) or ["L", "T"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs._device_line(), flush=True)
    print(subprocess.run([sys.executable, "-c", "import sys, torch; print("
                          "sys.version, torch.__version__, "
                          "torch.version.cuda)"],
                         capture_output=True, text=True).stdout, flush=True)
    t0 = time.perf_counter()
    if "L" in which:
        cs.phase_lm_parity()
        cs.phase_lm_blocks()
        cs.phase_lm_consistency()
        cs.phase_lm_serving()
        print(f"[lm] took {time.perf_counter() - t0:.1f} s", flush=True)
    t1_peak = None
    if "T" in which:
        counts, t1_peak = cs.phase_train()
        print(counts, flush=True)
    if "Y" in which:
        from repro_torch.graph.generators import grid_2d
        cs.phase_build()
        cs._dryrun_vs_card(grid_2d(1024, 1024))
        cs._dryrun_cli()
        if t1_peak is not None:
            cs._dryrun_t1(t1_peak)
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
