"""Counting service launcher: a thin CLI over ``repro_torch.service`` (a
copy of the JAX package's ``launch/serve.py``; engines run on the card
unless given ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --graph rmat:10 --templates u5,u7,path9 --rel-stderr 0.05 \\
        --template-edges "0-1,1-2,1-3@0"

Two modes share every engine/cache/obs flag:

* **batch** (default): each template becomes one request, the synchronous
  round scheduler drives them to completion, results print and the
  process exits.
* **serving** (``--http PORT``): starts the continuously-admitting
  :class:`~repro_torch.service.async_loop.AsyncCountingService` plus the
  stdlib HTTP/JSON front end (``POST /count``, ``GET /result/<id>``,
  ``/metrics``, ``/metrics.json``, ``/healthz``) and runs until
  SIGINT/SIGTERM. ``--templates`` are pre-warmed into the engine pool so
  the first interactive request never pays a cold engine build;
  ``--queue-depth`` bounds admission (overflow requests are shed with
  HTTP 429). ``--metrics-out`` writes the final snapshot on shutdown.

Failure containment knobs (both modes): ``--dispatch-timeout`` /
``--dispatch-retries`` shape the per-dispatch watchdog + retry budget;
``--inject`` arms the deterministic fault-injection harness (chaos
testing — e.g. ``--inject kernel.dispatch:raise:0.2``).

Each template in ``--templates`` becomes one service request (repeats are
real repeated requests — they exercise the engine cache and dispatch-group
sharing); names accept the registry plus dynamic ``path{k}`` / ``star{k}``
forms. ``--template-edges`` (repeatable) submits an *arbitrary* tree as
``"u-v,u-v,...[@root]"`` — the query API's TemplateSpec — and shares
caches/groups with any name spelling the same tree, because identity is
the canonical template hash. With ``--rel-stderr`` the scheduler stops
each request adaptively at the target precision, capped at ``--iters``;
without it every request runs exactly ``--iters`` iterations. Results
always report the estimate, its standard error, and the 95% confidence
interval from the per-iteration color-coding samples. Use ``--edge-list``
to serve a real graph; ``--results-cache`` persists answers across
invocations (the file's keys are the JAX package's, so either serves the
other). ``--device`` picks the card (``cuda``, the default) or the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch.core.templates import TemplateSpec
from repro_torch.device import resolve_device
from repro_torch.graph.generators import erdos_renyi, rmat
from repro_torch.graph.io import load_cached
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.obs.validate import validate_snapshot
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.retry import RetryPolicy
from repro_torch.service import (AsyncCountingService, CountingService,
                                 CountRequest)
from repro_torch.service.cache import DEFAULT_MAX_ENTRIES, EngineCache
from repro_torch.service.frontend import serve_forever


def _load_graph(spec: str, edge_list: str | None):
    if edge_list:
        return load_cached(edge_list)
    kind, _, arg = spec.partition(":")
    if kind == "rmat":
        return rmat(int(arg or 12), 16, seed=0)
    if kind == "er":
        n = int(arg or 1000)
        return erdos_renyi(n, 8.0, seed=0)
    raise ValueError(f"unknown graph spec {spec!r}")


def _retry_policy(args):
    return RetryPolicy(
        max_attempts=max(args.dispatch_retries, 1),
        timeout_s=args.dispatch_timeout if args.dispatch_timeout else None)


def _serve_http(args, g, budget, engine_kw) -> int:
    """Serving mode: async QoS service + HTTP front end until SIGINT."""
    import signal
    import threading

    svc = AsyncCountingService(
        ledger_root=args.ledger, round_size=args.round_size,
        default_max_iters=args.iters, batch_size=args.batch_size,
        memory_budget_bytes=budget,
        engine_cache=EngineCache(max_entries=args.engine_cache_size),
        estimate_cache=args.results_cache,
        engine_kw=engine_kw or None, device=args.device,
        max_queue_depth=args.queue_depth,
        warm_pool=not args.no_warm_pool,
        retry_policy=_retry_policy(args))
    svc.add_graph("g", g)
    # pre-warm the advertised templates: cold engine builds land here,
    # on startup/idle time, never on the first interactive request
    for tpl in [t for t in args.templates.split(",") if t]:
        svc.prewarm("g", tpl, args.engine, args.plan)
    for i, es in enumerate(args.template_edges):
        svc.prewarm("g", TemplateSpec.from_edge_string(es, name=f"edges{i}"),
                    args.engine, args.plan)
    httpd = serve_forever(svc, host=args.host, port=args.http)
    host, port = httpd.server_address[:2]
    print(f"serving HTTP on {host}:{port} (graph 'g', queue depth "
          f"{args.queue_depth}); POST /count, GET /result/<id>, "
          f"/metrics, /metrics.json, /healthz", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        print("shutting down...", flush=True)
        httpd.shutdown()
        svc.close()
        if args.metrics_out:
            snap = obs_metrics.snapshot()
            validate_snapshot(snap)
            with open(args.metrics_out, "w") as f:
                json.dump(snap, f, indent=1, sort_keys=True)
            print(f"metrics snapshot -> {args.metrics_out}", flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="rmat:12")
    ap.add_argument("--edge-list", default=None)
    ap.add_argument("--templates", default="u5,u7")
    ap.add_argument("--template-edges", action="append", default=[],
                    metavar="EDGES",
                    help="arbitrary tree template as 'u-v,u-v,...[@root]' "
                         "(repeatable); shares caches with any registry "
                         "name spelling the same tree")
    ap.add_argument("--iters", type=int, default=64,
                    help="iteration cap (exact budget when no --rel-stderr)")
    ap.add_argument("--rel-stderr", type=float, default=None,
                    help="adaptive precision target (stderr / |estimate|)")
    ap.add_argument("--ledger", default=os.path.join(tempfile.gettempdir(),
                                                     "repro_torch_serve"))
    ap.add_argument("--results-cache", default=None,
                    help="JSON path for the persistent estimate cache")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="pgbsc")
    ap.add_argument("--plan", default="optimized",
                    choices=["plain", "dedup", "optimized"])
    ap.add_argument("--round-size", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="dispatch batch override (default: derived from "
                         "the memory budget by the executor's memory model)")
    ap.add_argument("--memory-budget-mb", type=float, default=None,
                    help="per-engine device table budget in MiB; sets the "
                         "dispatch batch size and, for large templates, "
                         "colorset-chunked execution")
    ap.add_argument("--engine-cache-size", type=int,
                    default=DEFAULT_MAX_ENTRIES,
                    help="max resident engines; evicted engines release "
                         "their device operands")
    ap.add_argument("--fuse", action="store_true",
                    help="does nothing in the port, whose engine fuses "
                         "SpMM->eMA by default; accepted so command lines "
                         "written for the JAX package's launcher still run")
    ap.add_argument("--reorder", default=None,
                    choices=("rcm", "degree"),
                    help="permute vertices once per engine for BSR "
                         "locality (rcm: fewer occupied tiles; degree: "
                         "gather-path balance); results stay in the "
                         "input vertex ids")
    ap.add_argument("--dtype", default=None,
                    choices=("float32", "float64", "bfloat16"),
                    help="node-table/adjacency storage dtype; bfloat16 "
                         "halves table bytes and accumulates in float32")
    ap.add_argument("--trace", action="store_true",
                    help="enable span tracing with device-sync timing; "
                         "prints a per-request latency breakdown "
                         "(queue/compile/execute) and a span summary")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the metrics-registry snapshot (validated "
                         "JSON, schema v1) to FILE on exit")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="arm a one-shot torch.profiler trace around the "
                         "first device dispatch, written to DIR")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serving mode: run the async QoS service behind "
                         "an HTTP/JSON front end on PORT until SIGINT "
                         "(0 = ephemeral port, printed on startup)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address for --http")
    ap.add_argument("--queue-depth", type=int, default=1024,
                    help="async admission-queue bound; overflow requests "
                         "are shed (HTTP 429 / status SHED)")
    ap.add_argument("--no-warm-pool", action="store_true",
                    help="disable idle-time engine pre-materialization "
                         "in serving mode")
    ap.add_argument("--inject", default=None, metavar="PLAN",
                    help="arm the fault-injection harness: inline "
                         "'point:mode[:rate[:times]],...' specs or a JSON "
                         "plan file (chaos testing; see repro_torch."
                         "resilience.faults)")
    ap.add_argument("--inject-seed", type=int, default=0,
                    help="seed for the deterministic fault schedule")
    ap.add_argument("--dispatch-timeout", type=float, default=120.0,
                    metavar="S",
                    help="wall-clock watchdog per device dispatch; a hung "
                         "dispatch is abandoned and retried (0 = off)")
    ap.add_argument("--dispatch-retries", type=int, default=4,
                    metavar="N",
                    help="retry budget per dispatch (jittered exponential "
                         "backoff between attempts)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engines run; cpu runs the kernels' "
                         "plain PyTorch versions")
    args = ap.parse_args(argv)
    resolve_device(args.device)       # no card: fail before any work

    if args.trace:
        obs_tracing.configure(enabled=True, sync=True)
    if args.profile_dir:
        obs_tracing.arm_profiler(args.profile_dir)
    if args.inject:
        plan = _faults.FaultPlan.parse(args.inject, seed=args.inject_seed)
        _faults.install_plan(plan)
        print(f"fault injection armed: {len(plan.specs)} spec(s), "
              f"seed {args.inject_seed}", flush=True)

    g = _load_graph(args.graph, args.edge_list)
    print(f"serving graph: n={g.n} edge-slots={g.m} "
          f"avg_deg={g.avg_degree:.1f} fingerprint={g.fingerprint[:12]}")

    budget = None if args.memory_budget_mb is None \
        else int(args.memory_budget_mb * 2 ** 20)
    engine_kw = {}
    if args.reorder:
        engine_kw["reorder"] = args.reorder
    if args.dtype:
        engine_kw["dtype"] = getattr(torch, args.dtype)
    if args.http is not None:
        return _serve_http(args, g, budget, engine_kw)
    svc = CountingService(
        ledger_root=args.ledger, round_size=args.round_size,
        default_max_iters=args.iters, batch_size=args.batch_size,
        memory_budget_bytes=budget,
        engine_cache=EngineCache(max_entries=args.engine_cache_size),
        estimate_cache=args.results_cache,
        engine_kw=engine_kw or None, device=args.device,
        retry_policy=_retry_policy(args))
    svc.add_graph("g", g)
    templates: list = [t for t in args.templates.split(",") if t]
    for i, es in enumerate(args.template_edges):
        templates.append(TemplateSpec.from_edge_string(es, name=f"edges{i}"))
    rids = []
    for tpl in templates:
        rid = svc.submit(CountRequest(
            graph="g", template=tpl, engine=args.engine, plan=args.plan,
            rel_stderr=args.rel_stderr, max_iters=args.iters,
            seed=args.seed))
        label = tpl if isinstance(tpl, str) else tpl.display_name
        rids.append((rid, label))
    svc.run()

    results = {}
    for rid, tname in rids:
        res = svc.result(rid)
        d = res.to_dict()
        results[f"{rid}:{tname}"] = d
        lo, hi = res.ci95
        tags = [t for t, on in (("cache", res.from_cache),
                                ("shared", res.shared_group)) if on]
        print(f"  {rid} {tname}: estimate={res.estimate:.6g} "
              f"+- {res.stderr:.3g} (rel={res.rel_stderr:.3g}, "
              f"ci95=[{lo:.6g}, {hi:.6g}], {res.iterations} iters, "
              f"{res.seconds:.1f}s{', ' + '+'.join(tags) if tags else ''})")
        if args.trace and res.breakdown:
            b = res.breakdown
            accounted = b["queue_s"] + b["compile_s"] + b["execute_s"]
            pct = 100.0 * accounted / b["total_s"] if b["total_s"] else 100.0
            print(f"      breakdown: queue={b['queue_s'] * 1e3:.1f}ms "
                  f"compile={b['compile_s'] * 1e3:.1f}ms "
                  f"execute={b['execute_s'] * 1e3:.1f}ms "
                  f"total={b['total_s'] * 1e3:.1f}ms "
                  f"({pct:.1f}% accounted)")

    stats = svc.stats()
    results["_service"] = stats
    ec = stats["engine_cache"]
    print(f"engine builds: {ec['builds']} for {len(rids)} requests "
          f"(cache hits {ec['hits']}, dispatch groups {stats['groups']})")
    if args.rel_stderr is not None:
        fixed = args.iters * len(rids)
        used = stats["unique_iterations"]
        print(f"adaptive stopping: {used} device iterations vs "
              f"{fixed} fixed-budget baseline "
              f"({100 * (1 - used / max(fixed, 1)):.0f}% saved)")

    if args.trace:
        agg = obs_tracing.get_tracer().breakdown()
        print("span summary (count, total seconds):")
        for name, ent in sorted(agg.items(),
                                key=lambda kv: -kv[1]["seconds"]):
            print(f"  {name:<24s} x{ent['count']:<5d} "
                  f"{ent['seconds']:.3f}s")
    if args.metrics_out:
        snap = obs_metrics.snapshot()
        validate_snapshot(snap)
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        print(f"metrics snapshot (schema {snap['schema']}, "
              f"{len(snap['counters'])} counters, "
              f"{len(snap['histograms'])} histograms) "
              f"-> {args.metrics_out}")
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
