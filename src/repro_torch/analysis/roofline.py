"""Kernel roofline: where one measured kernel launch sits against the card.

An own copy of the kernel half of the JAX package's
``analysis/roofline.py`` (:class:`KernelRoofline`, :func:`spmm_ema_flops`,
:func:`spmm_ema_hbm_bytes`), with the same formulas and field names. The
peaks are arguments, never constants of some chip: ``chip_smoke.py``
measures the card's memory rate (the larger of a copy's and a read's) and
f32 rate and passes them here, and takes every eMA, fused and group
kernel's bytes and flops from the two functions below, so a fraction is
read against what this card delivers, with its power limit beside it.
The HLO half of the reference (roofline terms of a compiled artifact)
serves its models and dry-run launcher, which the port does not have
yet.
"""

from __future__ import annotations

import dataclasses

__all__ = ["KernelRoofline", "spmm_ema_flops", "spmm_ema_hbm_bytes"]


@dataclasses.dataclass
class KernelRoofline:
    """Achieved-vs-peak placement of ONE measured kernel launch.

    ``flops`` are the *useful* flops of the operation (nnz-based SpMM +
    split FMAs, not whatever an implementation happens to execute);
    ``hbm_bytes`` is its modeled device-memory traffic; ``seconds`` its
    measured time; ``peak_flops`` and ``peak_bw`` the card's rates in
    FLOP/s and bytes/s, measured on the same card.
    """

    name: str
    flops: float
    hbm_bytes: float
    seconds: float
    peak_flops: float
    peak_bw: float

    @property
    def achieved_flops(self) -> float:
        return self.flops / self.seconds if self.seconds > 0 else 0.0

    @property
    def achieved_bw(self) -> float:
        """Modeled traffic delivered per second: the roofline's y-axis for
        a memory-bound kernel."""
        return self.hbm_bytes / self.seconds if self.seconds > 0 else 0.0

    @property
    def oi(self) -> float:
        """Operational intensity (flops / byte)."""
        return self.flops / self.hbm_bytes if self.hbm_bytes > 0 else 0.0

    @property
    def bound(self) -> str:
        return ("compute" if self.oi * self.peak_bw > self.peak_flops
                else "memory")

    @property
    def bound_seconds(self) -> float:
        """The least time the card could take at these peaks: the larger
        of the traffic over ``peak_bw`` and the flops over ``peak_flops``
        (``roof_fraction`` is this over ``seconds``). Not in the
        reference, whose callers read only the fraction."""
        return max(self.hbm_bytes / self.peak_bw if self.peak_bw else 0.0,
                   self.flops / self.peak_flops if self.peak_flops else 0.0)

    @property
    def roof_fraction(self) -> float:
        """Achieved flops as a fraction of the roofline at this OI."""
        roof = min(self.peak_flops, self.oi * self.peak_bw)
        return self.achieved_flops / roof if roof > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "name": self.name, "flops": self.flops,
            "hbm_bytes": self.hbm_bytes, "seconds": self.seconds,
            "achieved_gflops": self.achieved_flops / 1e9,
            "achieved_gbps": self.achieved_bw / 1e9,
            "oi": self.oi, "bound": self.bound,
            "roof_fraction": self.roof_fraction,
        }


def spmm_ema_flops(b: int, e: int, n: int, c_p: int, s: int, l: int) -> int:
    """Useful flops of one plan-node step over a coloring batch ``b``:
    nnz-based SpMM (2 flops per edge per passive color set) plus the split
    FMAs (2 flops per vertex per (set, split))."""
    return b * (2 * e * c_p + 2 * n * s * l)


def spmm_ema_hbm_bytes(b: int, n: int, c_a: int, c_p: int, s: int,
                       adj_bytes: int, itemsize: int, *,
                       fused: bool, adj_passes: int = 1) -> int:
    """Modeled device-memory traffic of one plan-node step (tables +
    adjacency).

    Both variants read the active and passive tables and write the output
    table; the unfused pair also round-trips the ``(b, c_p, n)``
    neighbor-sum table through device memory (the SpMM writes it, the eMA
    reads it back), the traffic the fused kernel keeps in shared memory.
    The adjacency is charged ``adj_passes`` times. ``itemsize`` is the
    storage dtype's width (bf16 tables move 2 bytes an entry; the sums
    stay f32 on chip).
    """
    tables = b * n * (c_a + c_p + s)
    if not fused:
        tables += 2 * b * n * c_p
    return tables * itemsize + adj_bytes * adj_passes
