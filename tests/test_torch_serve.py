"""The port's launcher (``python -m repro_torch.launch.serve``) against the
JAX package's: batch mode in-process with ``--device cpu``, the same
flags through both, and the HTTP mode in a subprocess on an ephemeral
port, stopped by SIGTERM."""

import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.launch import serve as ref_serve  # noqa: E402
from repro.obs.validate import validate_snapshot as ref_validate  # noqa: E402
from repro.resilience import faults as ref_faults  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.graph.io import save_edge_list  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs.validate import validate_snapshot  # noqa: E402
from repro_torch.resilience import faults  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F32_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _clean_state():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)
    faults.clear_plan()
    ref_faults.clear_plan()


def _results(out: str) -> dict:
    """The results object the launcher prints last."""
    lines = out.splitlines()
    start = max(i for i, ln in enumerate(lines) if ln == "{")
    return json.loads("\n".join(lines[start:]))


def _run(main, capsys, argv):
    main(argv)
    return _results(capsys.readouterr().out)


@pytest.fixture
def edge_list(tmp_path):
    p = str(tmp_path / "g.txt")
    save_edge_list(generators.erdos_renyi(120, 4.0, seed=0), p)
    return p


def _args(tmp_path, edge_list, name, *extra):
    return ["--edge-list", edge_list, "--templates", "u5,path4,u5",
            "--template-edges", "0-1,1-2,2-3@0", "--iters", "8",
            "--round-size", "4", "--ledger", str(tmp_path / name), *extra]


def test_batch_mode_equals_the_reference(tmp_path, edge_list, capsys):
    ref = _run(ref_serve.main, capsys, _args(tmp_path, edge_list, "ref"))
    got = _run(serve.main, capsys,
               _args(tmp_path, edge_list, "port", "--device", "cpu"))
    assert got.keys() == ref.keys()
    for k in got:
        if k == "_service":
            continue
        assert got[k]["iterations"] == ref[k]["iterations"] == 8
        np.testing.assert_allclose(got[k]["estimate"], ref[k]["estimate"],
                                   rtol=F32_RTOL)
    assert got["_service"]["groups"] == ref["_service"]["groups"] == 2
    assert got["_service"]["engine_cache"]["builds"] == 2
    # path4 spelt by name and as an edge list share one sample stream
    by_name = [v for k, v in got.items() if k.endswith(":path4")]
    by_edges = [v for k, v in got.items() if k.endswith(":edges0")]
    assert by_name[0]["estimate"] == by_edges[0]["estimate"]
    assert by_edges[0]["shared_group"]


def test_metrics_snapshot_validates_in_both_packages(tmp_path, edge_list,
                                                      capsys):
    out = str(tmp_path / "metrics.json")
    _run(serve.main, capsys, _args(tmp_path, edge_list, "m", "--device",
                                   "cpu", "--metrics-out", out, "--trace"))
    with open(out) as f:
        snap = json.load(f)
    validate_snapshot(snap)
    ref_validate(snap)
    assert any(k.startswith("engine_cache_builds_total")
               for k in snap["counters"])
    assert snap["gauges"]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_results_cache_file_serves_across_launchers(tmp_path, edge_list,
                                                    capsys, writer):
    cache = str(tmp_path / "results.json")
    first, second = (ref_serve.main, serve.main) if writer == "reference" \
        else (serve.main, ref_serve.main)
    port_args = ["--device", "cpu"]
    a = _run(first, capsys, _args(tmp_path, edge_list, "a",
                                  "--results-cache", cache,
                                  *(port_args if first is serve.main
                                    else [])))
    b = _run(second, capsys, _args(tmp_path, edge_list, "b",
                                   "--results-cache", cache,
                                   *(port_args if second is serve.main
                                     else [])))
    assert b["_service"]["engine_cache"]["builds"] == 0
    for k, v in b.items():
        if k != "_service":
            assert v["from_cache"] and v["estimate"] == a[k]["estimate"]


def test_fused_flag_bf16_and_injected_fault(tmp_path, edge_list, capsys):
    """``--fuse`` keeps the engine default's answer, ``--dtype bfloat16``
    stays within bf16 storage's tolerance, and an injected dispatch fault
    is retried to the same estimate."""
    base = _run(serve.main, capsys,
                _args(tmp_path, edge_list, "a", "--device", "cpu"))
    fused = _run(serve.main, capsys,
                 _args(tmp_path, edge_list, "b", "--device", "cpu",
                       "--fuse"))
    bf16 = _run(serve.main, capsys,
                _args(tmp_path, edge_list, "c", "--device", "cpu",
                      "--dtype", "bfloat16"))
    chaos = _run(serve.main, capsys,
                 _args(tmp_path, edge_list, "d", "--device", "cpu",
                       "--inject", "kernel.dispatch:raise:1.0:2",
                       "--dispatch-timeout", "0"))
    for k, v in base.items():
        if k == "_service":
            continue
        assert fused[k]["estimate"] == v["estimate"]
        assert chaos[k]["estimate"] == v["estimate"]
        np.testing.assert_allclose(bf16[k]["estimate"], v["estimate"],
                                   rtol=1e-2)


def test_http_mode_serves_until_sigterm(tmp_path, edge_list):
    metrics = str(tmp_path / "metrics.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--edge-list", edge_list, "--templates", "u5", "--http",
         "0", "--iters", "8", "--ledger", str(tmp_path / "led"),
         "--metrics-out", metrics], stdout=subprocess.PIPE, text=True,
        env=env, cwd=str(tmp_path))
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("serving HTTP on"):
                port = int(line.split()[3].split(":")[1])
                break
        assert port is not None, "the server never announced its port"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/count",
            data=json.dumps({"graph": "g", "templates": ["u5"],
                             "max_iters": 8}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            (ent,) = json.load(resp)["requests"]
        assert ent["status"] == "done"
        assert ent["result"]["iterations"] == 8
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    with open(metrics) as f:
        snap = json.load(f)
    validate_snapshot(snap)
    ref_validate(snap)
