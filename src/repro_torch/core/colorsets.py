"""Color-set indexing (paper Eq. 1) and active/passive split tables.

A color set C = {c_1 < c_2 < ... < c_h} drawn from k colors is ranked into
``I_C = C(c_1,1) + C(c_2,2) + ... + C(c_h,h)`` — the combinatorial number
system, a bijection onto [0, C(k,h)).

For a sub-template of size t split into an active child of size t_a and a
passive child of size t_p (t_a + t_p = t), ``split_tables`` enumerates, for
every ranked color set of size t, all C(t, t_a) (active, passive) sub-set rank
pairs. These tables are static per template step and drive the eMA kernel.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import combinations
from math import comb

import numpy as np

__all__ = [
    "comb",
    "rank_colorset",
    "unrank_colorset",
    "all_colorsets",
    "split_tables",
    "colorful_probability",
]


def rank_colorset(colors) -> int:
    """Rank a sorted color tuple via the combinatorial number system."""
    cs = sorted(colors)
    return sum(comb(c, i + 1) for i, c in enumerate(cs))


def unrank_colorset(index: int, h: int, k: int) -> tuple[int, ...]:
    """Inverse of rank_colorset for sets of size h drawn from k colors."""
    out = []
    rem = index
    for i in range(h, 0, -1):
        # largest c with comb(c, i) <= rem
        c = i - 1
        while comb(c + 1, i) <= rem:
            c += 1
        out.append(c)
        rem -= comb(c, i)
    return tuple(sorted(out))


@lru_cache(maxsize=None)
def all_colorsets(k: int, h: int) -> tuple[tuple[int, ...], ...]:
    """All size-h subsets of [0,k) ordered by their rank."""
    sets = list(combinations(range(k), h))
    sets.sort(key=rank_colorset)
    # ranks must be exactly 0..C(k,h)-1
    assert [rank_colorset(s) for s in sets] == list(range(comb(k, h)))
    return tuple(sets)


@lru_cache(maxsize=None)
def split_tables(k: int, t: int, t_a: int) -> tuple[np.ndarray, np.ndarray]:
    """Active/passive rank tables.

    Returns (IA, IP), both int32 of shape (C(k, t), C(t, t_a)):
    for ranked color set j of size t and split l, ``IA[j, l]`` is the rank of
    the active subset (size t_a) and ``IP[j, l]`` the rank of the passive
    complement (size t - t_a).
    """
    t_p = t - t_a
    n_sets = comb(k, t)
    n_splits = comb(t, t_a)
    ia = np.zeros((n_sets, n_splits), dtype=np.int32)
    ip = np.zeros((n_sets, n_splits), dtype=np.int32)
    for j, cset in enumerate(all_colorsets(k, t)):
        for l, a_sub in enumerate(combinations(cset, t_a)):
            p_sub = tuple(c for c in cset if c not in a_sub)
            assert len(p_sub) == t_p
            ia[j, l] = rank_colorset(a_sub)
            ip[j, l] = rank_colorset(p_sub)
    return ia, ip


def colorful_probability(k: int) -> float:
    """P(a fixed k-vertex embedding is colorful) = k!/k^k."""
    p = 1.0
    for i in range(1, k + 1):
        p *= i / k
    return p
