"""NequIP-style E(3)-equivariant GNN (l_max = 2) in Cartesian form.

A port of the JAX package's ``models/equivariant.py`` to an ``nn.Module``.
Irreps are Cartesian tensors (equivalent to real spherical harmonics up to
an orthogonal change of basis, which preserves equivariance):

    l=0  scalars             (N, C0)
    l=1  vectors             (N, C1, 3)
    l=2  symmetric traceless (N, C2, 3, 3)

Edge "spherical harmonics": Y0 = 1, Y1 = r_hat, Y2 = r_hat r_hat^T - I/3.
The 14 tensor-product paths (l1 x l2 -> l3) use closed Cartesian forms
(dot, cross, matvec, symmetric-traceless outer/anticommutator, Levi-Civita
contraction), weighted per channel by a radial MLP over n_rbf Bessel bases
with a smooth polynomial cutoff. Gates: scalars pass through SiLU; l>0
features are gated by sigmoid(scalar channels). Forces are ``-dE/dpos``
by ``torch.autograd.grad`` (:func:`nequip_forces`). Parity is not tracked
per channel, as in the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.gnn import Dense, _normal, segment_sum

__all__ = ["sym_traceless", "bessel_basis", "PATHS", "NequIP",
           "build_nequip", "nequip_forward", "nequip_energy_loss",
           "nequip_forces"]

_EPS = 1e-9

# tensor-product paths used per interaction: (l_in, l_sh, l_out)
PATHS = [(0, 0, 0), (0, 1, 1), (0, 2, 2),
         (1, 0, 1), (1, 1, 0), (1, 1, 1), (1, 1, 2), (1, 2, 1),
         (2, 0, 2), (2, 1, 1), (2, 2, 0), (2, 1, 2), (2, 2, 1), (2, 2, 2)]


# ---------------------------------------------------------------- tensor ops
def sym_traceless(m):
    s = 0.5 * (m + m.transpose(-1, -2))
    tr = s.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return s - tr * torch.eye(3, dtype=m.dtype, device=m.device) / 3.0


def _levi_civita_contract(m, n):
    """(2 x 2 -> 1): v_i = eps_{ijk} (M N)_{jk}."""
    mn = m @ n
    return torch.stack([mn[..., 1, 2] - mn[..., 2, 1],
                        mn[..., 2, 0] - mn[..., 0, 2],
                        mn[..., 0, 1] - mn[..., 1, 0]], dim=-1)


def bessel_basis(r, n_rbf: int, cutoff: float):
    """(E,) -> (E, n_rbf) sinc-like Bessel bases with polynomial cutoff."""
    r = torch.clamp(r, min=_EPS)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(
        n * math.pi * r[:, None] / cutoff) / r[:, None]
    # smooth cutoff envelope (p=6 polynomial, NequIP eq. 8)
    u = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1 - 28 * u**6 + 48 * u**7 - 21 * u**8
    return basis * env[:, None]


def _apply_mlp(layers, x):
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1:
            x = F.silu(x)
    return x


def _tp_accumulate(x0, x1, x2, y1, y2, w):
    """Weighted tensor products of gathered node features with the edge
    harmonics ``y1`` (E, 3) and ``y2`` (E, 3, 3); ``w`` (E, n_paths, C)
    radial weights. -> per-edge messages (E, C), (E, C, 3), (E, C, 3, 3)."""
    e, c = w.shape[0], w.shape[2]
    out = [w.new_zeros((e, c)), w.new_zeros((e, c, 3)),
           w.new_zeros((e, c, 3, 3))]
    y1b = y1[:, None, :]                       # (E, 1, 3)
    y2b = y2[:, None, :, :]                    # (E, 1, 3, 3)
    for pi, path in enumerate(PATHS):
        wp = w[:, pi, :]                       # (E, C)
        if path == (0, 0, 0):
            r = x0
        elif path == (0, 1, 1):
            r = x0[..., None] * y1b
        elif path == (0, 2, 2):
            r = x0[..., None, None] * y2b
        elif path == (1, 0, 1):
            r = x1
        elif path == (1, 1, 0):
            r = torch.einsum("eci,ei->ec", x1, y1)
        elif path == (1, 1, 1):
            r = torch.linalg.cross(x1, y1b.expand_as(x1), dim=-1)
        elif path == (1, 1, 2):
            r = sym_traceless(x1[..., :, None] * y1b[..., None, :])
        elif path == (1, 2, 1):
            r = torch.einsum("eij,ecj->eci", y2, x1)
        elif path == (2, 0, 2):
            r = x2
        elif path == (2, 1, 1):
            r = torch.einsum("ecij,ej->eci", x2, y1)
        elif path == (2, 2, 0):
            r = torch.einsum("ecij,eij->ec", x2, y2)
        elif path == (2, 1, 2):
            # T_ij = sym_traceless( eps_iab y_a M_bj ): cross y with columns
            mc = x2.transpose(-1, -2)                       # (E, C, j, b)
            crossed = torch.linalg.cross(
                y1b[:, :, None, :].expand_as(mc), mc, dim=-1)  # (E, C, j, i)
            r = sym_traceless(crossed.transpose(-1, -2))
        elif path == (2, 2, 1):
            r = _levi_civita_contract(x2, y2b.expand_as(x2))
        else:                                  # (2, 2, 2)
            r = sym_traceless(x2 @ y2b + y2b @ x2)
        lo = path[2]
        out[lo] = out[lo] + wp[(...,) + (None,) * lo] * r
    return out


# -------------------------------------------------------------------- model
class _Interaction(nn.Module):
    def __init__(self, c, n_rbf, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        # radial MLP emits one weight per (path, channel)
        self.radial = nn.ModuleList([Dense(n_rbf, 32, **kw),
                                     Dense(32, len(PATHS) * c, **kw)])
        # per-l self-interaction channel mixers, and gate scalars for l=1, 2
        self.mix0 = _normal((c, c), c ** -0.5, **kw)
        self.mix1 = _normal((c, c), c ** -0.5, **kw)
        self.mix2 = _normal((c, c), c ** -0.5, **kw)
        self.gate = _normal((c, 2 * c), c ** -0.5, **kw)

    def forward(self, f0, f1, f2, y1, y2, rbf, src, dst):
        n, c = f0.shape
        w = _apply_mlp(self.radial, rbf).reshape(-1, len(PATHS), c)
        msg = _tp_accumulate(f0.index_select(0, src), f1.index_select(0, src),
                             f2.index_select(0, src), y1, y2, w)
        agg = [segment_sum(m, dst, n) for m in msg]
        # self-interaction + residual
        h0 = f0 + agg[0] @ self.mix0
        h1 = f1 + torch.einsum("ncI,cd->ndI", agg[1], self.mix1)
        h2 = f2 + torch.einsum("ncIJ,cd->ndIJ", agg[2], self.mix2)
        # gated nonlinearity
        gates = torch.sigmoid(h0 @ self.gate)            # (N, 2C)
        return (F.silu(h0), h1 * gates[:, :c, None],
                h2 * gates[:, c:, None, None])


class NequIP(nn.Module):
    """The interatomic potential of a ``GNNConfig(kind="nequip")`` (extras
    ``n_rbf``, ``cutoff``): species embedding, ``cfg.n_layers``
    interactions, and a readout MLP pooled per graph into energies."""

    def __init__(self, cfg, n_species: int, *, device, generator):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.d_hidden, cfg.param_dtype
        kw = dict(dtype=dt, device=device, generator=generator)
        self.species_embed = _normal((n_species, c), 0.1, **kw)
        self.layers = nn.ModuleList(
            _Interaction(c, cfg.extra("n_rbf", 8), **kw)
            for _ in range(cfg.n_layers))
        self.readout = nn.ModuleList([Dense(c, 32, **kw), Dense(32, 1, **kw)])

    def forward(self, batch: dict):
        """batch: positions (N,3), species (N,), edge_index (2,E),
        node_graph (N,), n_graphs. Returns per-graph energies (n_graphs,)."""
        pos = batch["positions"]
        src, dst = batch["edge_index"]
        n, c = pos.shape[0], self.cfg.d_hidden
        rel = pos.index_select(0, src) - pos.index_select(0, dst)   # (E, 3)
        # eps goes into each component before the norm, as the reference's
        dist = torch.linalg.norm(rel + _EPS, dim=-1)
        r_hat = rel / torch.clamp(dist, min=_EPS)[:, None]
        y2 = sym_traceless(r_hat[:, :, None] * r_hat[:, None, :])
        rbf = bessel_basis(dist, self.cfg.extra("n_rbf", 8),
                           self.cfg.extra("cutoff", 5.0))
        f0 = self.species_embed[batch["species"].long()]
        f1 = f0.new_zeros((n, c, 3))
        f2 = f0.new_zeros((n, c, 3, 3))
        for layer in self.layers:
            f0, f1, f2 = layer(f0, f1, f2, r_hat, y2, rbf, src, dst)
        energy_per_node = _apply_mlp(self.readout, f0)[:, 0]
        return segment_sum(energy_per_node, batch["node_graph"],
                           batch["n_graphs"])


def build_nequip(cfg, n_species: int = 16, *, device=None,
                 generator=None) -> NequIP:
    """A :class:`NequIP` of ``cfg`` on ``device`` (CUDA unless ``"cpu"``),
    drawn from ``generator`` as :func:`repro_torch.models.gnn.build_gnn`
    draws."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return NequIP(cfg, n_species, device=dev, generator=generator)


def nequip_forward(model: NequIP, batch: dict):
    return model(batch)


def nequip_energy_loss(model: NequIP, batch: dict):
    e = nequip_forward(model, batch)
    return torch.mean((e - batch["labels"].to(e.dtype)) ** 2)


def nequip_forces(model: NequIP, batch: dict):
    """-> (energies (n_graphs,), forces (N, 3) = -dE/dpos). The energies
    keep their graph, so a loss on them can still be taken back."""
    pos = batch["positions"].detach().requires_grad_(True)
    energy = nequip_forward(model, dict(batch, positions=pos))
    (grad,) = torch.autograd.grad(energy.sum(), pos, retain_graph=True)
    return energy, -grad
