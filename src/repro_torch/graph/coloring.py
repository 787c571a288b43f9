"""Random vertex coloring (color-coding phase 1), bit-exact with the JAX
package's ``graph/coloring.py``.

The reference draws ``jax.random.randint(fold_in(PRNGKey(seed), it), (n,),
0, k)`` with the threefry2x32 generator in its partitionable mode (the
default of jax 0.9). This module reproduces that stream with torch int64
arithmetic masked to 32 bits, so every coloring — and therefore every
estimator sample — matches the reference sample by sample, and the
colorings of a batch are generated on the device that runs the count.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

__all__ = ["iteration_key", "random_coloring", "batch_colorings"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of counter pairs ``(x1, x2)`` under
    key ``(k1, k2)``; uint32 values carried in int64 tensors that broadcast
    against each other."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _MASK
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def _key(seed: int, device) -> torch.Tensor:
    """``PRNGKey(seed)`` as a (2,) int64 tensor: the seed bit-cast to two
    uint32 words (the high word is 0 for a 32-bit seed)."""
    seed = int(seed)
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & _MASK
    return torch.tensor([hi, seed & _MASK], dtype=torch.int64, device=device)


def _fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fold_in`` for a batch of keys ``(..., 2)`` and data ``(...)``: the
    hash of the counter pair ``(0, data)``."""
    a, b = _threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                         data & _MASK)
    return torch.stack([a, b], dim=-1)


def _random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element for keys ``(B, 2)`` -> ``(B, n)``:
    partitionable threefry hashes the 64-bit iota split into two words."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = _threefry2x32(key[:, :1], key[:, 1:], torch.zeros_like(lo), lo)
    return b1 ^ b2


def _randint(key: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """``randint(key, (n,), 0, k)`` in int32 for keys ``(B, 2)``.

    The key splits in two (partitionable ``split``: counters (0, 0) and
    (0, 1)); the two bit streams combine as ``(hi % k) * (2^32 % k) +
    lo % k``, all modulo ``k``, exactly as the reference's span-modular
    arithmetic does in uint32."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    k1 = torch.stack(_threefry2x32(key[:, 0], key[:, 1], zero, zero), -1)
    k2 = torch.stack(_threefry2x32(key[:, 0], key[:, 1], zero, zero + 1), -1)
    hi, lo = _random_bits(k1, n), _random_bits(k2, n)
    mult = ((1 << 16) % k) ** 2 % k
    return (((hi % k) * mult + lo % k) % k).to(torch.int32)


def iteration_key(seed: int, iteration: int, device=None) -> torch.Tensor:
    """Deterministic per-iteration key ``fold_in(PRNGKey(seed), iteration)``
    as a (2,) int64 tensor of two uint32 words (``device=None`` is CUDA)."""
    device = resolve_device(device)
    it = torch.tensor(int(iteration), dtype=torch.int64, device=device)
    return _fold_in(_key(seed, device), it)


def random_coloring(key: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Uniform color in [0, k) per vertex, int32 (n,)."""
    return _randint(key.reshape(1, 2), n, k)[0]


def batch_colorings(seed: int, iterations, n: int, k: int,
                    device=None) -> torch.Tensor:
    """(B, n) int32 colorings for a batch of iteration ids, generated on
    ``device`` (``None`` is CUDA). Row b equals the reference's
    ``random_coloring(iteration_key(seed, iterations[b]), n, k)``."""
    device = resolve_device(device)
    its = torch.as_tensor(list(iterations), dtype=torch.int64, device=device)
    keys = _fold_in(_key(seed, device).expand(its.shape[0], 2), its)
    return _randint(keys, n, k)
