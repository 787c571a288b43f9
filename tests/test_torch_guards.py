"""Guards of the port's package rules.

The port imports torch and numpy, never JAX or the JAX package; its entry
points run on CUDA unless asked for the CPU; and the card's shared-memory
fit model decides which plan nodes run the fused kernel.
"""

import ast
import subprocess
import sys
from math import comb
from pathlib import Path

import pytest
import torch

from repro_torch import api, interop
from repro_torch.core.distributed import coloring_for_seed
from repro_torch.core.engines import CountingEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.templates import get_template
from repro_torch.data.synthetic import (gnn_batch, lm_batch, lm_token_stream,
                                        make_batch, recsys_batch)
from repro_torch.device import resolve_device
from repro_torch.graph.coloring import batch_colorings, iteration_key
from repro_torch.graph.generators import grid_2d
from repro_torch.kernels.fused.ops import fused_fits_smem
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.models.equivariant import build_nequip
from repro_torch.models.gnn import build_gnn
from repro_torch.models.recsys import build_autoint
from repro_torch.models.transformer import build_lm, init_decode_cache
from repro_torch.train.ddp import init_ddp_state
from repro_torch.train.step import abstract_train_state, concrete_train_state

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "examples").glob("*_torch.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.api, repro_torch.interop, "
            "repro_torch.configs, repro_torch.models.gnn, "
            "repro_torch.models.equivariant, repro_torch.optim.optimizer, "
            "repro_torch.models.transformer, repro_torch.models.recsys, "
            "repro_torch.data.synthetic, repro_torch.graph, "
            "repro_torch.obs; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    env_path = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         env={"PYTHONPATH": env_path, "PATH": "/usr/bin"})
    assert out.stdout.strip() == "False"


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        CountingEngine(grid_2d(4, 4), "u5")
    assert resolve_device("cpu") == torch.device("cpu")


_TINY = grid_2d(4, 4)
_TINY_BSR = {"blocks": torch.eye(128).reshape(1, 128, 128).numpy(),
             "src_tile": [0], "dst_tile": [0]}
ENTRY_POINTS = {
    "prepare": lambda **kw: spmm_ops.prepare(_TINY, **kw),
    "from_arrays": lambda **kw: spmm_ops.from_arrays(
        _TINY.n, _TINY_BSR["blocks"], [0], [0], **kw),
    "bsr_from_arrays": lambda **kw: interop.bsr_from_arrays(
        _TINY.n, _TINY_BSR, **kw),
    "splits_from_arrays": lambda **kw: interop.splits_from_arrays(
        {1: ([[0]], [[0]])}, **kw),
    "batch_colorings": lambda **kw: batch_colorings(0, range(2), 5, 3, **kw),
    "iteration_key": lambda **kw: iteration_key(0, 1, **kw),
    "coloring_for_seed": lambda **kw: coloring_for_seed(0, 128, 16, 3, **kw),
    "api.count": lambda **kw: api.count(_TINY, "u3", max_iters=1, **kw),
    "api.count_many": lambda **kw: api.count_many(
        _TINY, ["u3", "path4", "star4"], max_iters=1, **kw),
    "api.compile_query": lambda **kw: api.compile_query(
        _TINY, api.CountQuery(templates=("path4", "star4"), max_iters=1),
        **kw),
    "api.motif_features": lambda **kw: api.motif_features(
        _TINY, ["u3", "star4"], n_iters=1, **kw),
    "prepare_gather": lambda **kw: spmm_ops.prepare(_TINY, "gather", **kw),
    "gather_engine": lambda **kw: CountingEngine(
        _TINY, "u5", spmm_method="gather", **kw),
    "bundle_engine": lambda **kw: CountingEngine(
        _TINY, ["path4", "star4"], plan="dedup", **kw),
    "fascia_engine": lambda **kw: CountingEngine(
        _TINY, "u5", engine="fascia", **kw),
    "pfascia_engine": lambda **kw: CountingEngine(
        _TINY, "u5", engine="pfascia", **kw),
    "prepare_segment": lambda **kw: spmm_ops.prepare(_TINY, "segment", **kw),
    "prepare_ell": lambda **kw: spmm_ops.prepare(_TINY, "ell", **kw),
    "prepare_dense": lambda **kw: spmm_ops.prepare(_TINY, "dense", **kw),
    "build_gnn": lambda **kw: build_gnn(
        reduced_config("graphsage-reddit").model, 4, **kw),
    "build_nequip": lambda **kw: build_nequip(
        reduced_config("nequip").model, **kw),
    "gnn_batch": lambda **kw: gnn_batch(reduced_config("pna"), "smoke_full",
                                        0, **kw),
    "gnn_from_params": lambda **kw: interop.gnn_from_params(
        reduced_config("pna").model, interop.params_to_arrays(build_gnn(
            reduced_config("pna").model, 4, device="cpu")), 4, **kw),
    "nequip_from_params": lambda **kw: interop.nequip_from_params(
        reduced_config("nequip").model, interop.params_to_arrays(
            build_nequip(reduced_config("nequip").model, device="cpu")),
        **kw),
    "build_lm": lambda **kw: build_lm(
        reduced_config("deepseek-moe-16b").model, **kw),
    "build_autoint": lambda **kw: build_autoint(
        reduced_config("autoint").model, **kw),
    "lm_batch": lambda **kw: lm_batch(reduced_config("gemma3-1b"),
                                      "smoke_decode", 0, **kw),
    "recsys_batch": lambda **kw: recsys_batch(reduced_config("autoint"),
                                              "smoke_retrieval", 0, **kw),
    "lm_token_stream": lambda **kw: lm_token_stream(0, 2, 4, 10, **kw),
    "init_decode_cache": lambda **kw: init_decode_cache(
        reduced_config("llama3-8b").model, 1, 4, **kw),
    "lm_from_params": lambda **kw: interop.lm_from_params(
        reduced_config("qwen3-moe-30b-a3b").model, interop.params_to_arrays(
            build_lm(reduced_config("qwen3-moe-30b-a3b").model,
                     device="cpu")), **kw),
    "autoint_from_params": lambda **kw: interop.autoint_from_params(
        reduced_config("autoint").model, interop.params_to_arrays(
            build_autoint(reduced_config("autoint").model, device="cpu")),
        **kw),
    "decode_cache_from_arrays": lambda **kw: interop.decode_cache_from_arrays(
        interop.decode_cache_to_arrays(init_decode_cache(
            reduced_config("smollm-360m").model, 1, 4, device="cpu")), **kw),
    "make_batch": lambda **kw: make_batch(reduced_config("autoint"),
                                          "smoke_train", 0, **kw),
    "concrete_train_state": lambda **kw: concrete_train_state(
        reduced_config("gemma3-1b"), 0, **kw),
    "init_ddp_state": lambda **kw: init_ddp_state(
        build_lm(reduced_config("smollm-360m").model, device="cpu"), **kw),
    "train_state_from_arrays": lambda **kw: interop.train_state_from_arrays(
        reduced_config("autoint"), interop.train_state_to_arrays(
            concrete_train_state(reduced_config("autoint"), 0,
                                 device="cpu")), **kw),
    "launch.train.main": lambda **kw: _train_main(**kw),
}


def _train_main(device=None):
    from repro_torch.launch import train
    return train.main(["--arch", "autoint", "--reduced", "--steps", "1"]
                      + (["--device", device] if device else []))


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda_and_runs_when_asked_for_cpu(
        name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()
    ENTRY_POINTS[name](device="cpu")


def test_new_modules_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/core/motif_features.py",
            "src/repro_torch/api.py", "chip_smoke.py",
            "src/repro_torch/core/runner.py",
            "src/repro_torch/core/oracle.py",
            "src/repro_torch/resilience/__init__.py",
            "src/repro_torch/resilience/faults.py",
            "src/repro_torch/resilience/recovery.py",
            "src/repro_torch/resilience/retry.py",
            "src/repro_torch/resilience/degradation.py",
            "src/repro_torch/service/__init__.py",
            "src/repro_torch/service/cache.py",
            "src/repro_torch/service/qos.py",
            "src/repro_torch/service/scheduler.py",
            "src/repro_torch/service/async_loop.py",
            "src/repro_torch/service/frontend.py",
            "src/repro_torch/launch/__init__.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/graph/io.py",
            "src/repro_torch/obs/validate.py",
            "src/repro_torch/core/distributed.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/ranks.py",
            "src/repro_torch/configs/__init__.py",
            "src/repro_torch/configs/base.py",
            "src/repro_torch/configs/shapes.py",
            "src/repro_torch/configs/graphsage_reddit.py",
            "src/repro_torch/models/gnn.py",
            "src/repro_torch/models/equivariant.py",
            "src/repro_torch/optim/optimizer.py",
            "src/repro_torch/data/synthetic.py",
            "src/repro_torch/models/layers.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/models/recsys.py",
            "examples/serve_lm_torch.py",
            "examples/train_lm_torch.py",
            "src/repro_torch/train/__init__.py",
            "src/repro_torch/train/step.py",
            "src/repro_torch/train/sharding.py",
            "src/repro_torch/train/checkpoint.py",
            "src/repro_torch/train/ddp.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/analysis/roofline.py",
            "examples/gnn_motif_features_torch.py",
            "examples/quickstart_torch.py",
            "examples/distributed_counting_torch.py"} <= names


def test_abstract_train_state_allocates_nothing_and_needs_no_card(
        monkeypatch):
    """llama3-8b's whole train state (8.0e9 parameters, 96 GB with its
    moments) on the meta device: no storage anywhere, no card asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = abstract_train_state(get_config("llama3-8b"))
    model, opt = state["params"], state["opt"]
    params = list(model.parameters())
    assert sum(p.numel() for p in params) == 8_030_261_248
    assert all(p.device.type == "meta" for p in params)
    moments = [t for p in params for t in opt.state[p].values()]
    assert len(moments) == 2 * len(params)
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in moments)


def test_importing_the_training_layer_loads_no_jax():
    code = ("import sys, repro_torch.train.step, repro_torch.train.ddp, "
            "repro_torch.train.sharding, repro_torch.train.checkpoint, "
            "repro_torch.launch.train, repro_torch.configs.shapes, "
            "repro_torch.analysis.roofline; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.', "
            "'ml_dtypes')) for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin"})
    assert out.stdout.strip() == "False"


def test_importing_the_service_and_launcher_loads_no_jax():
    code = ("import sys, repro_torch.service, repro_torch.service.frontend, "
            "repro_torch.launch.serve, repro_torch.graph.io, "
            "repro_torch.obs.validate, repro_torch.resilience; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin"})
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("make", ["CountingService", "AsyncCountingService",
                                  "serve.main"])
def test_service_defaults_to_cuda_and_raises_without_a_card(make,
                                                            monkeypatch,
                                                            tmp_path):
    from repro_torch.launch import serve
    from repro_torch.service import AsyncCountingService, CountingService
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    led = str(tmp_path / "led")
    build = {
        "CountingService": lambda **kw: CountingService(ledger_root=led,
                                                        **kw),
        "AsyncCountingService": lambda **kw: AsyncCountingService(
            ledger_root=led, **kw),
        "serve.main": lambda **kw: serve.main(
            ["--graph", "er:40", "--templates", "u3", "--iters", "2",
             "--ledger", led]
            + (["--device", kw["device"]] if kw else [])),
    }[make]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    build(device="cpu")


def test_unknown_spmm_operand_raises():
    with pytest.raises(ValueError, match="gather"):
        spmm_ops.prepare(_TINY, "csr", device="cpu")
    with pytest.raises(ValueError, match="segment"):
        CountingEngine(_TINY, "u5", spmm_method="csr", device="cpu")
    with pytest.raises(ValueError, match="pfascia"):
        CountingEngine(_TINY, "u5", engine="fascia2", device="cpu")


def test_card_fit_model_admits_every_u12_sole_consumer():
    eng = CountingEngine(grid_2d(16, 16), "u12", plan="optimized",
                         device="cpu")
    admitted = [i for i, v in eng.fusion_report.items() if v == "admitted"]
    assert admitted == [3, 5, 7, 9, 11]
    assert all(v == "multi_consumer" for i, v in eng.fusion_report.items()
               if i not in admitted)


def test_card_fit_model_rejects_wide_passive_tables():
    plan = get_template("u15-1").plan_optimized
    widths = {i: comb(15, plan.nodes[nd.passive].size)
              for i, nd in enumerate(plan.nodes) if not nd.is_leaf}
    assert max(widths.values()) == 6435
    assert not fused_fits_smem(6435)
    assert fused_fits_smem(792) and fused_fits_smem(792, torch.bfloat16)
    eng = CountingEngine(grid_2d(4, 4), "u15-1", plan="optimized",
                         device="cpu", memory_budget_bytes=1 << 34)
    wide = [i for i, w in widths.items() if w == 6435]
    assert all(eng.fusion_report[i] == "smem_overflow" for i in wide)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_fit_model_admits_passive_tables_up_to_1560(dtype):
    """The fused kernel's m_a slice (at most 32 KB) beside y[c_p][32] in
    f32 fills the 227 KB a block may have exactly at c_p = 1,560, whatever
    the storage dtype."""
    from repro_torch.kernels.fused.ops import SMEM_LIMIT, fused_smem_bytes
    assert fused_smem_bytes(1560, dtype) == SMEM_LIMIT == 232_448
    assert fused_fits_smem(1560, dtype) and not fused_fits_smem(1561, dtype)


def test_kernel_library_loads_once_when_threads_race(monkeypatch):
    """The service's dispatcher and a warm-pool build may both reach the
    first kernel launch: one builds and loads the library, the other
    waits for it."""
    import threading
    import time
    import types

    from repro_torch.kernels import _build

    builds, loads = [], []

    class FakeLib:
        def __init__(self, path):
            loads.append(path)
            self.rt_error_string = types.SimpleNamespace()

    def slow_build(out):
        builds.append(out)
        time.sleep(0.2)                    # the other thread arrives here

    fake_ctypes = types.SimpleNamespace(CDLL=FakeLib, c_int=int,
                                        c_char_p=bytes)
    monkeypatch.setattr(_build, "_lib", [])
    monkeypatch.setattr(_build, "_build", slow_build)
    monkeypatch.setattr(_build, "ctypes", fake_ctypes)
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.library()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
        assert not t.is_alive()
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 4 and all(lib is got[0] for lib in got)
