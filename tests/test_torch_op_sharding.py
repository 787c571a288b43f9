"""The port's sharding plan on real DTensors: the scatters' rules
(``train/op_sharding``), the LM loss as vocab reductions, the MoE dispatch
per group and the decode hints.

Four gloo ranks (``launch/ranks.run_all``) on a ``(data 2, model 2)``
CPU ``DeviceMesh`` run, on the same numpy inputs:

- ``segment_sum`` (forward and backward), ``segment_counts`` and
  ``segment_max`` (and its backward), with ids and data split over the
  edges on ``data`` and the feature dim over ``model``, and with the edges
  split over both mesh dims: each equals the plain op on the whole
  tensors (f32 ``rtol 1e-6``; counts and the max exact), and the sum
  leaves a rank a partial sum (no gathered edge stream);
- ``lm_loss`` of a reduced LM with ``embed`` and ``lm_head`` vocab-split
  over ``model`` and the batch over ``data``: the loss and every gradient
  equal the plain loss's within ``rtol 1e-5`` of the largest magnitude,
  and the gradient reaching the logits is vocab-split;
- ``moe_ffn`` with its groups split over ``data`` and its experts over
  ``model``: equal to the reference's ``moe_ffn`` on the same numpy
  inputs (``rtol 1e-5`` of the largest magnitude);
- ``decode_attention`` on a sequence-split cache with the reference's
  decode hints: equal to it without them, and to the plain op.

On fake tensors over a fake ``(2, 2)`` group (``analysis/hlo``) the same
ops run nothing whole (``ran_whole``), and on plain tensors the per-group
dispatch equals the flat ``index_add_`` dispatch it replaces bit for bit.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.analysis import hlo  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.interop import _load  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.ranks import run_all  # noqa: E402
from repro_torch.models import gnn, moe  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import op_sharding  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
E_EDGES, N_NODES, D_FEAT = 64, 10, 8
MOE = dict(d=16, ff=24, e=8, k=2, n_shared=1, b=4, s=6, groups=4, cf=1.25)
LM_BATCH, LM_SEQ = 4, 8
DEC = dict(b=2, s=16, at=5)

_RANK = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch import nn
rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import reduced_config
from repro_torch.configs.shapes import PartitionSpec as P
from repro_torch.models import gnn, moe
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import op_sharding
op_sharding.install()
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
a = dict(np.load(inp))
res = {}
R = Replicate()


def place(x, *p):
    return distribute_tensor(torch.as_tensor(x), mesh, list(p))


def put(name, t):
    t = t.full_tensor() if isinstance(t, DTensor) else t
    res[name] = t.detach().numpy()


n = int(a["n_nodes"])
for tag, dp, ip in (("dm", (Shard(0), Shard(1)), (Shard(0), R)),
                    ("dd", (Shard(0), Shard(0)), (Shard(0), Shard(0)))):
    ids = place(a["ids"], *ip)
    w = place(a["w"], R, R)
    data = place(a["data"], *dp).requires_grad_(True)
    s = gnn.segment_sum(data, ids, n)
    res[f"sum_places_{tag}"] = np.array(str(s.placements))
    put(f"sum_{tag}", s)
    put(f"sum_grad_{tag}", torch.autograd.grad((s * w).sum(), data)[0])
    put(f"counts_{tag}", gnn.segment_counts(ids, n))
    data = place(a["data"], *dp).requires_grad_(True)
    mx = gnn.segment_max(data, ids, n)
    put(f"max_{tag}", mx)
    put(f"max_grad_{tag}", torch.autograd.grad((mx * w).sum(), data)[0])

# the LM loss: embed and lm_head vocab-split over model, batch over data
cfg = reduced_config("smollm-360m").model
model = T.build_lm(cfg, device="cpu")
split = {"embed": (R, Shard(0)), "lm_head": (R, Shard(1))}
for name, p in list(model.named_parameters()):
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    setattr(mod, leaf, nn.Parameter(place(p.detach(),
                                          *split.get(name, (R, R)))))
seen = {}
head = model.head


def spied_head(x):
    logits = head(x)
    seen["logits"] = str(logits.placements)
    logits.register_hook(
        lambda g: seen.__setitem__("grad", str(g.placements)))
    return logits


model.head = spied_head
names = [n for n, _ in model.named_parameters()]
with implicit_replication():
    loss = T.lm_loss(model, place(a["tokens"], Shard(0), R),
                     place(a["targets"], Shard(0), R))
    grads = torch.autograd.grad(loss, list(model.parameters()))
put("loss", loss)
for name, g in zip(names, grads):
    put("lm_grad/" + name, g)
res["logits_places"] = np.array(seen["logits"])
res["logits_grad_places"] = np.array(seen["grad"])

# the MoE: groups over data, experts over model
m = {k: int(a["moe_" + k]) for k in ("d", "ff", "e", "k", "n_shared",
                                     "groups")}
port = moe.MoE(m["d"], m["ff"], m["e"], m["n_shared"], dtype=torch.float32,
               device="cpu", generator=torch.Generator().manual_seed(0))
for name, p in list(port.named_parameters()):
    owner, _, leaf = name.rpartition(".")
    mod = port.get_submodule(owner) if owner else port
    expert = owner == "" and leaf.startswith("w_")
    setattr(mod, leaf, nn.Parameter(place(
        a["moe/" + name], R, Shard(0) if expert else R)))
with implicit_replication():
    y, aux = moe.moe_ffn(port, place(a["moe_x"], Shard(0), R),
                         top_k=m["k"], capacity_factor=float(a["moe_cf"]),
                         groups=m["groups"])
put("moe_out", y)
put("moe_aux", aux)

# decode attention on a sequence-split cache, with and without the hints
lm = T.build_lm(reduced_config("llama3-8b").model, device="cpu")
attn = lm.layers[0].attn
c = lm.cfg
kw = dict(n_heads=c.n_heads, n_kv=c.n_kv_heads, d_head=c.head_dim,
          theta=c.rope_theta)
hints = {"cache": P("data", "model", None, None),
         "logits": P("data", None, None, None, "model")}
for tag, h in (("hints", hints), ("none", None)):
    ck = place(a["cache_k"], Shard(0), Shard(1))
    cv = place(a["cache_v"], Shard(0), Shard(1))
    with implicit_replication(), torch.no_grad():
        o, ck, cv = L.decode_attention(
            attn, place(a["dec_x"], Shard(0), R), ck, cv,
            torch.tensor(int(a["dec_at"])), shard_hints=h, **kw)
    put("dec_" + tag, o)
    put("dec_k_" + tag, ck)
    put("dec_v_" + tag, cv)
    res["dec_k_places_" + tag] = np.array(str(ck.placements))
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
'''


def _inputs():
    rng = np.random.default_rng(0)
    a = {"n_nodes": N_NODES,
         "ids": rng.integers(0, N_NODES - 1, E_EDGES),   # the last empty
         "data": rng.normal(size=(E_EDGES, D_FEAT)).astype(np.float32),
         "w": rng.normal(size=(N_NODES, D_FEAT)).astype(np.float32)}
    cfg = reduced_config("smollm-360m").model
    a["tokens"] = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_SEQ))
    a["targets"] = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_SEQ))
    p, port = _moe_params()
    a.update({"moe/" + n: q.detach().numpy()
              for n, q in port.named_parameters()})
    a.update({"moe_" + k: MOE[k] for k in ("d", "ff", "e", "k", "n_shared",
                                           "groups", "cf")})
    a["moe_x"] = rng.normal(size=(MOE["b"], MOE["s"], MOE["d"])
                            ).astype(np.float32)
    c = reduced_config("llama3-8b").model
    shape = (DEC["b"], DEC["s"], c.n_kv_heads, c.head_dim)
    a["cache_k"] = rng.normal(size=shape).astype(np.float32)
    a["cache_v"] = rng.normal(size=shape).astype(np.float32)
    a["dec_x"] = rng.normal(size=(DEC["b"], 1, c.d_model)).astype(np.float32)
    a["dec_at"] = DEC["at"]
    return a


def _moe_params():
    p = jax.tree_util.tree_map(np.asarray, ref_moe.init_moe(
        jax.random.PRNGKey(3), MOE["d"], MOE["ff"], MOE["e"],
        MOE["n_shared"], jnp.float32))
    port = _load(moe.MoE(MOE["d"], MOE["ff"], MOE["e"], MOE["n_shared"],
                         dtype=torch.float32, device="cpu",
                         generator=torch.Generator().manual_seed(0)), p)
    return p, port


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("op_sharding")
    a = _inputs()
    np.savez(tmp / "in.npz", **a)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    cmds = {f"r{r}": [sys.executable, "-c", _RANK, str(r), "4",
                      str(tmp / "store"), str(tmp / "in.npz"),
                      str(tmp / "out.npz")] for r in range(4)}
    done = run_all(cmds, env, tmp, 240)
    for name, (rc, _, err) in done.items():
        assert rc == 0, f"{name} exited {rc}:\n{err[-4000:]}"
    return a, dict(np.load(tmp / "out.npz"))


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rtol * np.abs(want).max(initial=0.0), (what, err)


def _plain_segments(a):
    ids = torch.from_numpy(a["ids"])
    w = torch.from_numpy(a["w"])
    data = torch.from_numpy(a["data"]).requires_grad_(True)
    s = gnn.segment_sum(data, ids, N_NODES)
    gs, = torch.autograd.grad((s * w).sum(), data)
    data2 = torch.from_numpy(a["data"]).requires_grad_(True)
    mx = gnn.segment_max(data2, ids, N_NODES)
    gm, = torch.autograd.grad((mx * w).sum(), data2)
    return {"sum": s, "sum_grad": gs, "max": mx, "max_grad": gm,
            "counts": gnn.segment_counts(ids, N_NODES)}


@pytest.mark.parametrize("tag", ["dm", "dd"])
def test_segment_ops_on_split_edges_equal_the_plain_ops(ranks, tag):
    a, got = ranks
    want = _plain_segments(a)
    for k in ("sum", "sum_grad"):
        np.testing.assert_allclose(got[f"{k}_{tag}"],
                                   want[k].detach().numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    for k in ("max", "max_grad", "counts"):
        np.testing.assert_array_equal(got[f"{k}_{tag}"],
                                      want[k].detach().numpy(), err_msg=k)
    # each rank sums its own edges: a partial sum over the edge split
    places = str(got[f"sum_places_{tag}"])
    assert "Partial(sum)" in places
    if tag == "dm":
        assert places.endswith("Shard(dim=1))")      # features over model


def test_lm_loss_on_a_vocab_split_head_equals_the_plain_loss(ranks):
    a, got = ranks
    cfg = reduced_config("smollm-360m").model
    model = T.build_lm(cfg, device="cpu")
    loss = T.lm_loss(model, torch.from_numpy(a["tokens"]),
                     torch.from_numpy(a["targets"]))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    _close(got["loss"], loss.detach().numpy(), 1e-5, "loss")
    for (name, _), g in zip(model.named_parameters(), grads):
        _close(got["lm_grad/" + name], g.numpy(), 1e-5, name)
    # the logits and the gradient reaching them stay vocab-split
    assert "Shard(dim=2)" in str(got["logits_places"])
    assert "Shard(dim=2)" in str(got["logits_grad_places"])


def test_moe_ffn_with_groups_over_data_equals_reference(ranks):
    a, got = ranks
    p, _ = _moe_params()
    want, want_aux = jax.jit(lambda pp, xx: ref_moe.moe_ffn(
        pp, xx, top_k=MOE["k"], capacity_factor=MOE["cf"],
        groups=MOE["groups"]))(jax.tree_util.tree_map(jnp.asarray, p),
                               jnp.asarray(a["moe_x"]))
    _close(got["moe_out"], want, 1e-5, "out")
    _close(got["moe_aux"], want_aux, 1e-5, "aux")


def test_decode_hints_change_no_number(ranks):
    a, got = ranks
    lm = T.build_lm(reduced_config("llama3-8b").model, device="cpu")
    c = lm.cfg
    ck, cv = (torch.from_numpy(a[k].copy()) for k in ("cache_k", "cache_v"))
    with torch.no_grad():
        want, ck, cv = L.decode_attention(
            lm.layers[0].attn, torch.from_numpy(a["dec_x"]), ck, cv,
            torch.tensor(DEC["at"]), n_heads=c.n_heads, n_kv=c.n_kv_heads,
            d_head=c.head_dim, theta=c.rope_theta)
    for tag in ("hints", "none"):
        _close(got["dec_" + tag], want.numpy(), 1e-6, tag)
        _close(got["dec_k_" + tag], ck.numpy(), 1e-6, "k " + tag)
        _close(got["dec_v_" + tag], cv.numpy(), 1e-6, "v " + tag)
    _close(got["dec_hints"], got["dec_none"], 1e-6, "hints against none")
    for k in ("dec_k_", "dec_v_"):
        np.testing.assert_array_equal(got[k + "hints"], got[k + "none"])
    # the written cache keeps its sequence split
    assert str(got["dec_k_places_hints"]) == \
        "(Shard(dim=0), Shard(dim=1))"


# ------------------------------------------ the same ops, traced as rank 0
def _fake(mode, mesh, shape, placements, dtype=torch.float32, grad=False):
    """A DTensor of global ``shape`` at ``placements`` whose rank-0 shard
    is an empty fake tensor."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    with mode:
        t = torch.empty(local, dtype=dtype, requires_grad=grad)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _segments_step(data, ids, w):
    s = gnn.segment_sum(data, ids, N_NODES)
    mx = gnn.segment_max(data, ids, N_NODES)
    c = gnn.segment_counts(ids, N_NODES)
    return torch.autograd.grad(((s + mx) * w).sum(), data)[0], c


def _loss_step(x, w, t):
    logits = (x @ w).float()
    return torch.autograd.grad(T._SplitNLL.apply(logits, t).mean(), [x, w])


def _trace(build):
    """Trace ``build(mode, mesh) -> (fn, args)`` on a fake (2, 2) mesh."""
    from torch.distributed.tensor.experimental import implicit_replication
    op_sharding.install()
    with dr.fake_world(4):
        mesh = dr._mesh((2, 2), ("data", "model"), torch.device("cpu"))
        mode = FakeTensorMode()
        fn, args = build(mode, mesh)
        with implicit_replication():
            return hlo.trace_step(fn, *args, mode=mode)[1]


def _segments_case(mode, mesh):
    from torch.distributed.tensor import Replicate, Shard
    e, d = 4096, 64
    return _segments_step, (
        _fake(mode, mesh, (e, d), (Shard(0), Shard(1)), grad=True),
        _fake(mode, mesh, (e,), (Shard(0), Replicate()), torch.int64),
        _fake(mode, mesh, (N_NODES, d), (Replicate(), Replicate())))


def _loss_case(mode, mesh):
    from torch.distributed.tensor import Replicate, Shard
    b, s, d, v = 4, 16, 32, 4096
    return _loss_step, (
        _fake(mode, mesh, (b, s, d), (Shard(0), Replicate()), grad=True),
        _fake(mode, mesh, (d, v), (Replicate(), Shard(1)), grad=True),
        _fake(mode, mesh, (b, s), (Shard(0), Replicate()), torch.int64))


def _moe_case(mode, mesh):
    from torch.distributed.tensor import Replicate, Shard
    m = MOE
    port = moe.MoE(m["d"], m["ff"], m["e"], m["n_shared"],
                   dtype=torch.float32, device="meta", generator=None)
    for name, p in list(port.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = port.get_submodule(owner) if owner else port
        expert = owner == "" and leaf.startswith("w_")
        setattr(mod, leaf, torch.nn.Parameter(_fake(
            mode, mesh, p.shape, (Replicate(), Shard(0) if expert
                                  else Replicate()), grad=True)))
    x = _fake(mode, mesh, (m["b"], m["s"], m["d"]), (Shard(0), Replicate()),
              grad=True)

    def step(x):
        y, aux = moe.moe_ffn(port, x, top_k=m["k"], capacity_factor=m["cf"],
                             groups=m["groups"])
        return torch.autograd.grad(y.sum() + aux, [x] + list(
            port.parameters()))
    return step, (x,)


def _decode_case(mode, mesh):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs.shapes import PartitionSpec as P
    c = reduced_config("llama3-8b").model
    attn = L.Attention(c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
                       dtype=torch.float32, device="meta", generator=None)
    for name, p in list(attn.named_parameters()):
        setattr(attn, name, torch.nn.Parameter(_fake(
            mode, mesh, p.shape, (Replicate(), Replicate()))))
    shape = (DEC["b"], 256, c.n_kv_heads, c.head_dim)
    ck = _fake(mode, mesh, shape, (Shard(0), Shard(1)))
    cv = _fake(mode, mesh, shape, (Shard(0), Shard(1)))
    x = _fake(mode, mesh, (DEC["b"], 1, c.d_model), (Shard(0), Replicate()))
    hints = {"cache": P("data", "model", None, None),
             "logits": P("data", None, None, None, "model")}

    def step(x, ck, cv):
        with torch.no_grad():
            return L.decode_attention(
                attn, x, ck, cv, DEC["at"], n_heads=c.n_heads,
                n_kv=c.n_kv_heads, d_head=c.head_dim, shard_hints=hints)[0]
    return step, (x, ck, cv)


def _decode_layer_bytes():
    c = reduced_config("llama3-8b").model
    return DEC["b"] * 256 * c.n_kv_heads * c.head_dim * 4


# case -> (builder, bytes no single collective may reach)
TRACED = {
    # the edge stream's share of a model rank (4096 x 32 f32)
    "segments": (_segments_case, 4096 * 64 * 4 // 2),
    # a data-split (B, S, V) f32 tensor: the logits' vocab gathered
    "loss": (_loss_case, 4 * 16 * 4096 * 4 // 2),
    "moe": (_moe_case, None),
    # a data-split layer of the cache: the sequence gathered
    "decode": (_decode_case, _decode_layer_bytes() // 2),
}


@pytest.mark.parametrize("case", sorted(TRACED))
def test_traced_ops_run_nothing_whole(case):
    build, most = TRACED[case]
    trace = _trace(build)
    assert trace.whole == {}
    if most is not None:
        assert max((r.collective_bytes for r in trace.ops), default=0) \
            < most


# ------------------------------------------ one card: the parent's numbers
def _flat_dispatch(xg, slot, e, capacity):
    """The dispatch as it was before the per-group scatter: one
    ``index_add_`` into the flat ``(G * (E*C + 1), D)`` buffer."""
    g, t_g, top_k, d = *slot.shape, xg.shape[-1]
    width = e * capacity + 1
    flat = slot + width * torch.arange(g)[:, None, None]
    xk = xg[:, :, None, :].expand(g, t_g, top_k, d).reshape(-1, d)
    buf = xg.new_zeros((g * width, d)).index_add_(0, flat.reshape(-1), xk)
    return buf.reshape(g, width, d)[:, :-1].reshape(g, e, capacity, d)


@pytest.mark.parametrize("groups", [1, 2, 3])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_per_group_dispatch_is_bit_equal_to_the_flat_one(groups, cf,
                                                         monkeypatch):
    _, port = _moe_params()
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 6, MOE["d"])).astype(np.float32))
    seen = {}
    scatter = torch.scatter_add

    def spy(target, dim, index, src):
        out = scatter(target, dim, index, src)
        seen["buf"], seen["src"], seen["at"] = out, src, index
        return out
    monkeypatch.setattr(torch, "scatter_add", spy)
    moe.moe_ffn(port, x, top_k=MOE["k"], capacity_factor=cf, groups=groups)
    monkeypatch.undo()
    g, slots, d = seen["src"].shape
    e = port.router.shape[1]
    width = seen["buf"].shape[1]
    capacity = (width - 1) // e
    xg = x.reshape(g, -1, d)
    slot = seen["at"][..., 0].reshape(g, xg.shape[1], MOE["k"])
    want = _flat_dispatch(xg, slot, e, capacity)
    assert torch.equal(seen["buf"][:, :-1].reshape(g, e, capacity, d), want)


def _parent_segment_max(data, segment_ids, num_segments):
    """``segment_max`` as it was: autograd's own ``scatter_reduce``."""
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    mx = out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                            include_self=True)
    return torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))


def _parent_segment_counts(segment_ids, num_segments):
    return torch.zeros(num_segments, dtype=torch.int64).index_add_(
        0, segment_ids, torch.ones_like(segment_ids, dtype=torch.int64))


@pytest.mark.parametrize("ties", [False, True])
def test_segment_ops_on_plain_tensors_are_the_parents_bit_for_bit(ties):
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, N_NODES - 1, E_EDGES))
    x = rng.normal(size=(E_EDGES, D_FEAT))
    if ties:                       # rows tie for a segment's max
        x = np.round(x)
    w = torch.from_numpy(rng.normal(size=(N_NODES, D_FEAT)))
    outs = []
    for fn in (gnn.segment_max, _parent_segment_max):
        data = torch.from_numpy(x).float().requires_grad_(True)
        y = fn(data, ids, N_NODES)
        outs.append((y, torch.autograd.grad((y * w.float()).sum(), data)[0]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    got = gnn.segment_counts(ids, N_NODES)
    assert got.dtype == torch.int64
    assert torch.equal(got, _parent_segment_counts(ids, N_NODES))
    data = torch.from_numpy(x).float()
    assert torch.equal(gnn.segment_sum(data, ids, N_NODES),
                       torch.zeros(N_NODES, D_FEAT).index_add_(0, ids, data))


def test_lm_loss_on_plain_tensors_is_the_parents_bit_for_bit(monkeypatch):
    """The loss and every gradient equal the parent's form (``F.embedding``,
    ``logsumexp`` and a ``gather`` under autograd) exactly."""
    import torch.nn.functional as F
    a = _inputs()
    tokens, targets = (torch.from_numpy(a[k]) for k in ("tokens",
                                                         "targets"))
    model = T.build_lm(reduced_config("smollm-360m").model, device="cpu")

    def run():
        loss = T.lm_loss(model, tokens, targets)
        return [loss] + list(torch.autograd.grad(loss,
                                                 list(model.parameters())))
    got = run()

    monkeypatch.setattr(L, "lookup",
                        lambda table, ids: F.embedding(ids.long(), table))
    monkeypatch.setattr(L, "gather", torch.gather)
    want = run()
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
