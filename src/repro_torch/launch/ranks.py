"""Start several processes at once and wait for all of them: the
multi-rank runs of distributed counting (its tests' gloo ranks beside a
JAX process, ``tools/dist_multicard.py``'s one NCCL rank a card). A rank
that fails, or the deadline, stops the others, so a hung collective costs
its caller the timeout and no more."""

from __future__ import annotations

import subprocess
import time
from pathlib import Path

__all__ = ["run_all"]


def run_all(cmds: dict[str, list[str]], env: dict, out_dir: Path,
            timeout_s: float) -> dict[str, tuple[int, str, str]]:
    """Start every command (name -> argv) at once, its standard output
    and error to ``out_dir/<name>.out`` and ``.err``, and wait until all
    exit or ``timeout_s`` passes; the first non-zero exit or the deadline
    kills the rest. -> name -> (exit code, stdout, stderr)."""
    out_dir = Path(out_dir)
    procs, files = {}, {}
    try:
        for name, argv in cmds.items():
            files[name] = (open(out_dir / f"{name}.out", "wb"),
                           open(out_dir / f"{name}.err", "wb"))
            procs[name] = subprocess.Popen(argv, env=env,
                                           stdout=files[name][0],
                                           stderr=files[name][1])
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs.values()):
            if any(p.poll() not in (None, 0) for p in procs.values()) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        for fs in files.values():
            for f in fs:
                f.close()
    return {name: (p.returncode,
                   (out_dir / f"{name}.out").read_text(errors="replace"),
                   (out_dir / f"{name}.err").read_text(errors="replace"))
            for name, p in procs.items()}
