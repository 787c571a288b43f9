"""Training launcher: --arch <id> [--cell <cell>] on the card or the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --reduced --steps 20 --ckpt /tmp/ck [--device cpu]

A port of the JAX package's ``launch/train.py``, with its flags and its
printed lines, and ``--device`` (``cuda``, the default, or ``cpu``).
Checkpoints and resume go through :mod:`repro_torch.train.checkpoint`,
batches come from :func:`repro_torch.data.synthetic.make_batch`. Step
``it``'s batch is drawn from the numpy seed that
``np.random.SeedSequence((7, it))`` gives, where the reference folds
``it`` into ``PRNGKey(7)``: the batches follow the reference's
distributions, not its key stream.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.synthetic import make_batch, statics_for
from repro_torch.device import resolve_device
from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.step import build_train_step, concrete_train_state

__all__ = ["main", "batch_seed"]


def batch_seed(it: int) -> int:
    """The numpy seed of step ``it``'s batch."""
    return int(np.random.SeedSequence((7, it)).generate_state(1)[0])


def main(argv=None):
    """Run the launcher; -> (the train state, the last step's metrics or
    ``None`` when no step ran)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arch = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cell_name = args.cell or next(
        c.name for c in arch.cells if c.kind == "train")
    cell = arch.cell(cell_name)
    d_in = cell.dims.get("d_feat")
    statics = statics_for(arch, cell_name)

    state = concrete_train_state(arch, args.seed, d_in=d_in, device=dev)
    n_params = sum(p.numel() for p in state["params"].parameters())
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"arch={arch.arch_id} cell={cell_name} params={n_params / 1e6:.2f}M "
          f"devices={n_dev}")

    start = 0
    if args.ckpt:
        restored, extras = restore_checkpoint(args.ckpt, state)
        if restored is not None:
            state, start = restored, extras["step"]
            print(f"resumed from step {start}")

    step_fn = build_train_step(
        arch, AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps), statics=statics)

    t0 = time.time()
    metrics = None
    for it in range(start, args.steps):
        batch = make_batch(arch, cell_name, batch_seed(it), device=dev)
        state, metrics = step_fn(state, batch)
        if it % max(args.steps // 10, 1) == 0 or it == args.steps - 1:
            print(f"step {it:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt and (it + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, it + 1, state,
                            extras={"step": it + 1})
    print("done")
    return state, metrics


if __name__ == "__main__":
    main()
