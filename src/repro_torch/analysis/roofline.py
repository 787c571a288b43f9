"""Roofline analysis: a traced step's terms, and measured kernel placement.

Two layers live here, as in the JAX package's ``analysis/roofline.py``.

The kernel half (:class:`KernelRoofline`, :func:`spmm_ema_flops`,
:func:`spmm_ema_hbm_bytes`) has the reference's formulas and field names.
Its peaks are arguments, never constants of some chip: ``chip_smoke.py``
measures the card's memory rate (the larger of a copy's and a read's) and
f32 rate and passes them here, and takes every eMA, fused and group
kernel's bytes and flops from the two functions, so a fraction is read
against what this card delivers, with its power limit beside it.
:func:`model_flops` is the reference's formula for a train or serve
step's useful flops (``6 * N * tokens`` for a dense LM).

The step half (:class:`RooflineTerms`, :func:`roofline_from_trace`)
serves the dry run (``launch/dryrun``): rank 0's flops, bytes accessed
and collective bytes of one traced step (``analysis/hlo``) over one
card's peaks,

    compute    = flops / peak_flops
    memory     = bytes_accessed / mem_bw
    collective = collective_bytes / link_bw

the dominant term and the perfect-overlap bound (the largest). The
counts are per rank already, so they divide by one card's peaks, as the
reference's per-device HLO counts do. The peaks are the fields of a
:class:`Peaks`; :data:`H100_SXM` is the card's data sheet.
"""

from __future__ import annotations

import dataclasses

__all__ = ["RooflineTerms", "Peaks", "H100_SXM", "roofline_from_trace",
           "KernelRoofline", "spmm_ema_flops", "spmm_ema_hbm_bytes",
           "model_flops"]


@dataclasses.dataclass(frozen=True)
class Peaks:
    """One card's peak rates: ``flops`` a second, device-memory bytes a
    second (``mem_bw``) and interconnect bytes a second (``link_bw``)."""

    name: str
    flops: float
    mem_bw: float
    link_bw: float


# NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 Tensor Core GPU data sheet:
# BF16 tensor cores 1,979 TFLOP/s with sparsity, so 989.5 dense; HBM3
# 3.35 TB/s; NVLink 4 900 GB/s both directions together, so 450 GB/s each
H100_SXM = Peaks("H100 SXM5 80GB data sheet (bf16 dense tensor cores, "
                 "HBM3, NVLink 4 per direction)",
                 flops=989.5e12, mem_bw=3.35e12, link_bw=450e9)


@dataclasses.dataclass
class RooflineTerms:
    """A step's roofline terms on one card: the reference's fields,
    properties and ``as_dict`` keys, with the peaks as fields."""

    flops: float
    bytes_accessed: float
    collective_bytes: float
    chips: int
    peak_flops: float = H100_SXM.flops
    mem_bw: float = H100_SXM.mem_bw
    link_bw: float = H100_SXM.link_bw

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / self.mem_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def compute_fraction(self) -> float:
        """Fraction of roofline-limited time spent on the compute term —
        1.0 means perfectly compute-bound (the ideal for training)."""
        t = self.step_time_s
        return self.compute_s / t if t > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes": self.bytes_accessed,
            "collective_bytes": self.collective_bytes, "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "step_time_s": self.step_time_s,
        }


def roofline_from_trace(trace, chips: int,
                        peaks: Peaks = H100_SXM) -> RooflineTerms:
    """The terms of a traced step (``analysis/hlo.StepTrace``): rank 0's
    flops, bytes accessed and collective bytes over ``peaks``; the
    counterpart of the reference's ``roofline_from_compiled``."""
    from repro_torch.analysis.hlo import collective_bytes
    return RooflineTerms(
        flops=float(trace.flops), bytes_accessed=float(trace.bytes_accessed),
        collective_bytes=float(collective_bytes(trace)), chips=chips,
        peak_flops=peaks.flops, mem_bw=peaks.mem_bw, link_bw=peaks.link_bw)


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


def model_flops(arch, cell) -> float:
    """6*N*D (dense LM) / 6*N_active*D (MoE) and family-specific analogues.

    These are *global* useful flops per step; divide by devices before
    comparing to one device's rate.
    """
    fam = arch.family
    m = arch.model
    if fam == "lm":
        tokens = cell.dims["batch"] * (cell.dims["seq"]
                                       if cell.kind != "decode" else 1)
        n = m.active_param_count() if m.moe else m.param_count()
        mult = 6 if cell.kind == "train" else 2
        return mult * n * tokens
    if fam == "gnn":
        d = m.d_hidden
        if cell.name in ("molecule", "smoke_molecule"):
            e = cell.dims["e"] * cell.dims["batch"]
            n = cell.dims["n"] * cell.dims["batch"]
        else:
            e, n = cell.dims["e"], cell.dims["n"]
        # message construction + aggregation + update, per layer
        per_layer = 2 * e * d * 2 + 2 * n * d * d * 2
        mult = 3 if cell.kind == "train" else 1
        return mult * m.n_layers * per_layer
    # recsys
    b = cell.dims["batch"]
    f = m.n_sparse + 1
    per_ex = (f * m.embed_dim * m.d_attn * 2
              + m.n_attn_layers * (3 * f * m.d_attn ** 2 * 2
                                   + 2 * f * f * m.d_attn * 2
                                   + f * m.d_attn ** 2 * 2)
              + f * m.d_attn * 2)
    total = b * per_ex
    if cell.kind == "retrieval":
        total += cell.dims["n_candidates"] * cell.dims["d_cand"] * 2 * b
    mult = 3 if cell.kind == "train" else 1
    return mult * total
