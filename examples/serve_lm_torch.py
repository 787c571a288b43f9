"""Serve a reduced LM with batched decode requests (chunked prefill, then a
greedy decode loop), on the PyTorch/CUDA port.

The port's counterpart of ``examples/serve_lm.py``: the same reduced
gemma3 model (local/global attention serving), batch, prompt length,
chunk and cache length. The prompt fills the KV cache in 8-token chunks
(Sarathi-style: attention memory O(chunk x prefix) instead of
O(prompt^2)), then every request decodes 16 tokens greedily.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import lm_token_stream
from repro_torch.device import resolve_device
from repro_torch.interop import lm_from_params
from repro_torch.models.transformer import (build_lm, init_decode_cache,
                                            lm_decode_step,
                                            lm_prefill_chunked)

MODEL = dataclasses.replace(
    get_config("gemma3-1b").model, n_layers=6, d_model=128, n_heads=4,
    n_kv_heads=1, d_ff=256, vocab_size=1024, d_head=32, sliding_window=16,
    global_every=6, param_dtype=torch.float32, remat=False)
BATCH, PROMPT, GEN, S_MAX, CHUNK = 4, 24, 16, 64, 8


def serve(model, prompt: torch.Tensor, forced=None) -> dict:
    """Chunked prefill of ``prompt`` (B, PROMPT), then ``GEN`` greedy
    decode steps; ``forced`` (B, GEN), when given, is fed instead of the
    greedy tokens (teacher forcing). -> the fed tokens, the prefill's and
    every step's logits, the cache length and the timings."""
    dev = prompt.device
    cache = init_decode_cache(model.cfg, prompt.shape[0], S_MAX,
                              dtype=torch.float32, device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = lm_prefill_chunked(model, prompt, cache, chunk=CHUNK)
        prefill_logits = logits
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        fed, steps = [], []
        t0 = time.perf_counter()
        for i in range(GEN):
            if forced is not None:
                tok = forced[:, i:i + 1]
            fed.append(tok)
            logits, cache = lm_decode_step(model, cache, tok)
            steps.append(logits)
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(fed, dim=1), "prefill_logits": prefill_logits,
            "step_logits": steps, "len": int(cache["len"]),
            "prefill_s": prefill_s, "decode_s": decode_s}


def main(argv=None, *, params=None, prompt=None, forced=None) -> dict:
    """Run the example. ``params`` (the reference's ``init_lm`` pytree as
    numpy) and ``prompt`` replace the port's own draws; ``forced`` tokens
    teacher-force the decode (see :func:`serve`)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if params is not None:
        model = lm_from_params(MODEL, params, device=dev)
    else:
        model = build_lm(MODEL, device=dev, generator=torch.Generator(
            device=dev).manual_seed(args.seed))
    prompt = lm_token_stream(args.seed + 1, BATCH, PROMPT, MODEL.vocab_size,
                             device=dev) if prompt is None \
        else torch.as_tensor(prompt, device=dev)
    if forced is not None:
        forced = torch.as_tensor(forced, device=dev)
    out = serve(model, prompt, forced)
    print(f"chunked prefill({PROMPT} tokens x {BATCH} requests): "
          f"{out['prefill_s']:.2f}s")
    print(f"generated {GEN} tokens x {BATCH} requests in "
          f"{out['decode_s']:.2f}s ({BATCH * GEN / out['decode_s']:.1f} "
          f"tok/s) on {dev}")
    print("sample:", out["tokens"][0].tolist())
    if out["len"] != PROMPT + GEN:
        raise AssertionError(f"cache length {out['len']}")
    return out


if __name__ == "__main__":
    main()
