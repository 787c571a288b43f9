"""Quickstart on the PyTorch/CUDA port: count tree subgraphs in a graph
through the query API.

The port's counterpart of ``examples/quickstart.py``: one-call counting,
an arbitrary user tree, a multi-template query sharing sub-plans, and the
multi-request counting service, on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--n 500]
"""

import argparse

from repro_torch.api import CountQuery, TemplateSpec, compile_query, count
from repro_torch.core import count_subgraphs_exact, get_template
from repro_torch.graph import erdos_renyi
from repro_torch.service import CountingService, CountRequest


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--n", type=int, default=500, help="graph vertices")
    ap.add_argument("--iters", type=int, default=50,
                    help="colorings of the one-call counts")
    args = ap.parse_args(argv)
    dev = args.device
    g = erdos_renyi(args.n, 8.0, seed=0)
    print(f"graph: n={g.n} directed-edge-slots={g.m} "
          f"avg_deg={g.avg_degree:.1f}")

    # --- one-call counting -------------------------------------------------
    # count() accepts registry names, dynamic path{k}/star{k} names,
    # TemplateSpec objects, or raw edge lists; results carry the estimate,
    # its standard error, and a 95% confidence interval.
    out = {}
    for tname in ("u3", "u5", "u7"):
        t = get_template(tname)
        res = count(g, tname, max_iters=args.iters, seed=42, device=dev)
        line = (f"{tname} (k={t.k}, aut={t.automorphisms}): "
                f"estimate={res.estimate:.4g} +- {res.stderr:.2g}")
        if g.n <= 60:  # exact verification is exponential; small graphs
            line += f"  exact={count_subgraphs_exact(g, t)}"
        print(line)
        out[tname] = res.estimate

    # an arbitrary user tree: no registry entry needed
    chair = TemplateSpec(edges=((0, 1), (1, 2), (1, 3)), name="chair")
    res = count(g, chair, max_iters=32, seed=7, device=dev)
    print(f"{chair.display_name} (hash {chair.canonical_hash[:8]}): "
          f"estimate={res.estimate:.4g} +- {res.stderr:.2g}")
    out["chair"] = res.estimate

    # --- multi-template queries: cross-template subplan sharing ------------
    # same-k templates fuse into ONE execution plan: canonical rooted
    # sub-templates they share are computed once per coloring. The SpMM
    # column-op counters show it.
    bundle = ["u5", "path5", "star5", "u7"]
    cq = compile_query(g, CountQuery(templates=bundle, max_iters=16, seed=1),
                       device=dev)
    for name, r in zip(bundle, cq.run()):
        print(f"count_many {name}: estimate={r.estimate:.4g} +- "
              f"{r.stderr:.2g} ({r.iterations} iters"
              f"{', fused' if r.shared_group else ''})")
    fused_cols = sum(e.n_spmm_cols_dispatched for e in cq.engines)
    solo_cols = 0
    for name in bundle:
        solo = compile_query(g, CountQuery(templates=[name], max_iters=16,
                                           seed=1), device=dev)
        solo.run()
        solo_cols += sum(e.n_spmm_cols_dispatched for e in solo.engines)
    print(f"SpMM column-ops: fused={fused_cols} vs per-template={solo_cols} "
          f"({100 * (1 - fused_cols / solo_cols):.0f}% saved by subplan "
          f"sharing)")
    out["spmm_cols"] = (fused_cols, solo_cols)

    # --- multi-request counting service ------------------------------------
    # requests carry a precision target (rel_stderr); engines are cached by
    # graph fingerprint x template hash, and requests whose templates are
    # the SAME tree, by any spelling, consume one sample stream.
    relabeled_path4 = TemplateSpec(edges=((3, 2), (2, 1), (1, 0)), root=3)
    svc = CountingService(round_size=16, default_max_iters=64, device=dev)
    svc.add_graph("demo", g)
    rids = [svc.submit(CountRequest("demo", tpl, rel_stderr=0.15))
            for tpl in ("u3", "path4", relabeled_path4)]
    svc.run()
    for rid in rids:
        r = svc.result(rid)
        lo, hi = r.ci95
        print(f"service {rid}: estimate={r.estimate:.4g} +- {r.stderr:.2g} "
              f"ci95=[{lo:.4g}, {hi:.4g}] ({r.iterations} iters"
              f"{', shared' if r.shared_group else ''})")
    stats = svc.stats()
    print(f"service: {stats['engine_cache']['builds']} engine builds for "
          f"{stats['requests']} requests, {stats['groups']} dispatch groups, "
          f"{stats['unique_iterations']} device iterations")
    out["service"] = [svc.result(rid).estimate for rid in rids]
    out["service_stats"] = stats
    return out


if __name__ == "__main__":
    main()
