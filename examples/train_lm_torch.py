"""Train a reduced smollm-family LM for a few hundred steps with the full
substrate: synthetic pipeline, AdamW + cosine, checkpoint/resume, on the
PyTorch/CUDA port.

The port's counterpart of ``examples/train_lm.py``: the same reduced model
(4 layers, d_model 256, 4/2 heads, d_ff 512, vocab 2048, f32, no remat),
batch, sequence, optimizer and checkpoint cadence. Step ``it``'s tokens
come from the numpy seed ``np.random.SeedSequence((1234, it))`` gives, where
the reference folds ``it`` into ``PRNGKey(1234)``.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 100 \
        [--resume] [--device cpu]

(the loss should drop visibly within 100 steps on the synthetic zipf
stream.)
"""

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data.synthetic import lm_token_stream
from repro_torch.device import resolve_device
from repro_torch.optim.optimizer import AdamWConfig
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.step import build_train_step, concrete_train_state


def make_arch(batch: int, seq: int):
    base = get_config("smollm-360m")
    model = dataclasses.replace(
        base.model, n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab_size=2048, param_dtype=torch.float32, remat=False)
    return dataclasses.replace(
        base, model=model,
        cells=(ShapeCell("train", "train", {"seq": seq, "batch": batch}),))


def batch_for(it: int, batch: int, seq: int, vocab: int, device) -> dict:
    """Step ``it``'s tokens and next-token targets."""
    seed = int(np.random.SeedSequence((1234, it)).generate_state(1)[0])
    toks = lm_token_stream(seed, batch, seq + 1, vocab, device=device)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def main(argv=None) -> dict:
    """Train; -> {"losses": {step: loss}, "state": the train state}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "lm_ckpt_torch"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arch = make_arch(args.batch, args.seq)
    state = concrete_train_state(arch, 0, device=dev)
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"params: {n_params / 1e6:.1f}M")

    start = 0
    if args.resume:
        restored, extras = restore_checkpoint(args.ckpt, state)
        if restored is not None:
            state, start = restored, extras["step"]
            print(f"resumed from step {start}")

    step_fn = build_train_step(
        arch, AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps))

    losses = {}
    t0 = time.time()
    for it in range(start, args.steps):
        batch = batch_for(it, args.batch, args.seq, arch.model.vocab_size,
                          dev)
        state, metrics = step_fn(state, batch)
        losses[it] = float(metrics["loss"])
        if it % 10 == 0 or it == args.steps - 1:
            print(f"step {it:4d} loss={losses[it]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if (it + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, it + 1, state, extras={"step": it + 1})
            print(f"checkpointed at step {it + 1}")
    print("done")
    return {"losses": losses, "state": state}


if __name__ == "__main__":
    main()
