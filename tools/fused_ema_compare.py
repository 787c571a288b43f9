"""Times the eMA, fused SpMM->eMA and shared-passive group kernels of
whichever ``repro_torch`` is importable, on one H100, at the shapes the
three paths of ``chip_smoke.py`` launch them with.

Run it once per tree to compare two versions of the port in one call:

    PYTHONPATH=<tree>/src python3 tools/fused_ema_compare.py --label <name>

``--kernels group`` (or ``ema``, ``fused``, comma-separated) times only
those kernels.

It prints, each line tagged with ``--label``, the mean device time (CUDA
events over three calls after one untimed call) of:

* the eMA (``ema_ops.ema``) at u12 node 6 ``(4, 924, n) x (4, 12, n)``, S =
  792, L = 7, f32 and bf16, and at the swapped shape of node 5; at path B's
  batch of 7 for both; at the census's ``(2, 210, n) x (2, 120, n)``, S =
  120, L = 35, and at a census root ``(2, 252, n)`` twice, S = 1, L = 252;
* the fused kernel (``fused_ops.fused_spmm_ema``) on ``grid_2d(1024,
  1024)`` at u12 node 5 ``(4, 12, n) x (4, 792, n)``, S = 924, L = 6, and
  the same launch with one output row (its SpMM leg nearly alone), then
  at three census shapes (c_p = 252, S = 1; c_p = 252, S = 10; c_p = 210,
  S = 45), f32 and bf16;
* the group kernel (``fused_ops.fused_spmm_ema_shared``) on the same mesh
  at the four group shapes of the k=10 census, batch 2, every consumer a
  template root (S = 1): two consumers of ``(2, 252, n)``, three and two
  of ``(2, 210, n)``, two of ``(2, 120, n)``, f32 and bf16; in f32 also
  one consumer of ``(2, 210, n)``, and one with a single row and term
  (its SpMM leg nearly alone).

Each result at batch 4 or less is checked against the plain version
(``equal``: bit for bit in f32, within 1e-2 relative in bf16). Tables are
integers in [0, 4), drawn on the card from a fixed seed. It exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import math
import sys


def _time_ms(fn, reps: int = 3) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _same(got, want, dtype) -> bool:
    import torch
    if dtype == torch.float32:
        return torch.equal(got, want)
    rel = (got.float() - want.float()).abs() / want.float().abs().clamp_min(1)
    return bool(rel.max() <= 1e-2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--kernels", default="ema,fused,group",
                    help="comma-separated subset of ema, fused, group")
    args = ap.parse_args()
    kinds = set(args.kernels.split(","))
    import torch
    if not torch.cuda.is_available():
        print("fused_ema_compare: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.colorsets import split_tables
    from repro_torch.graph.generators import grid_2d
    from repro_torch.kernels.ema import ops as ema_ops
    from repro_torch.kernels.fused import ops as fused_ops
    from repro_torch.kernels.spmm import ops as spmm_ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g = grid_2d(1024, 1024)
    n = g.n

    def tables(b, k, t, t_a, dt):
        ia, ip = (torch.as_tensor(a, dtype=torch.int32, device=dev)
                  for a in split_tables(k, t, t_a))
        m_a, m_p = (torch.empty((b, math.comb(k, c), n), dtype=dt,
                                device=dev).random_(0, 4, generator=gen)
                    for c in (t_a, t - t_a))
        return m_a, m_p, ia, ip

    def line(kind, tag, dt, m_a, m_p, ia, ms, ok):
        print(f"[{args.label}] {kind} {tag} {str(dt)[6:]} "
              f"m_a={tuple(m_a.shape)} m_p={tuple(m_p.shape)} "
              f"S={ia.shape[0]} L={ia.shape[1]} ms={ms:.3f} equal={ok}",
              flush=True)

    f32, bf16 = torch.float32, torch.bfloat16
    for b, k, t, t_a, dt, tag in () if "ema" not in kinds else (
            (4, 12, 7, 6, f32, "u12 node 6"), (4, 12, 7, 6, bf16, "u12 node 6"),
            (4, 12, 7, 1, f32, "u12 node 5 shape"),
            (7, 12, 7, 6, f32, "path B node 6"),
            (7, 12, 7, 1, f32, "path B node 5 shape"),
            (2, 10, 7, 4, f32, "census"), (2, 10, 10, 5, f32, "census root")):
        m_a, m_p, ia, ip = tables(b, k, t, t_a, dt)
        ok = _same(ema_ops.ema(m_a, m_p, ia, ip),
                   ema_ops.ema_plain(m_a, m_p, ia, ip), dt) if b <= 4 else None
        ms = _time_ms(lambda: ema_ops.ema(m_a, m_p, ia, ip))
        line("ema", tag, dt, m_a, m_p, ia, ms, ok)
        del m_a, m_p
        torch.cuda.empty_cache()
    for dt in (f32, bf16) if "fused" in kinds else ():
        prep = spmm_ops.prepare(g, dtype=dt, device=dev)
        for b, k, t, t_a, tag in ((4, 12, 6, 1, "u12 node 5"),
                                  (2, 10, 10, 5, "census"),
                                  (2, 10, 9, 4, "census"),
                                  (2, 10, 8, 4, "census")):
            m_a, m_p, ia, ip = tables(b, k, t, t_a, dt)
            ok = _same(fused_ops.fused_spmm_ema(m_a, m_p, ia, ip, prep),
                       fused_ops.fused_spmm_ema_plain(m_a, m_p, ia, ip, prep),
                       dt)
            ms = _time_ms(lambda: fused_ops.fused_spmm_ema(m_a, m_p, ia, ip,
                                                           prep))
            line("fused", tag, dt, m_a, m_p, ia, ms, ok)
            if tag == "u12 node 5":
                one_a, one_p = ia[:1].contiguous(), ip[:1].contiguous()
                ms = _time_ms(lambda: fused_ops.fused_spmm_ema(
                    m_a, m_p, one_a, one_p, prep))
                line("fused", "u12 node 5, one output row", dt, m_a, m_p,
                     one_a, ms, None)
            del m_a, m_p
            torch.cuda.empty_cache()
        del prep
        torch.cuda.empty_cache()
    for dt in (f32, bf16) if "group" in kinds else ():
        prep = spmm_ops.prepare(g, dtype=dt, device=dev)
        # (consumers, t_a) of the census's groups: every member is a root
        # (t = 10) over a passive of C(10, 10 - t_a) colour sets
        for cons, t_a in ((2, 5), (3, 4), (2, 4), (2, 3)):
            ia, ip = (torch.as_tensor(a, dtype=torch.int32, device=dev)
                      for a in split_tables(10, 10, t_a))
            m_p = torch.empty((2, math.comb(10, 10 - t_a), n), dtype=dt,
                              device=dev).random_(0, 4, generator=gen)
            m_as = [torch.empty((2, math.comb(10, t_a), n), dtype=dt,
                                device=dev).random_(0, 4, generator=gen)
                    for _ in range(cons)]
            ias, ips = [ia] * cons, [ip] * cons
            got = fused_ops.fused_spmm_ema_shared(m_as, m_p, ias, ips, prep)
            want = fused_ops.fused_spmm_ema_shared_plain(m_as, m_p, ias,
                                                         ips, prep)
            ok = all(_same(a, w, dt) for a, w in zip(got, want))
            del got, want
            torch.cuda.empty_cache()
            ms = _time_ms(lambda: fused_ops.fused_spmm_ema_shared(
                m_as, m_p, ias, ips, prep))
            line("group", f"census {cons} consumers", dt, m_as[0], m_p, ia,
                 ms, ok)
            if (cons, t_a, dt) == (3, 4, f32):
                # the same passive with one consumer, then with one of a
                # single row and term (the leg nearly alone)
                one = [m_as[0]], [ia], [ip]
                zero = torch.zeros((1, 1), dtype=torch.int32, device=dev)
                lone = [m_as[0][:, :1].contiguous()], [zero], [zero]
                for tag, (ms_, is_, ps_) in (("census 1 consumer", one),
                                             ("leg alone", lone)):
                    ok = all(_same(a, w, dt) for a, w in zip(
                        fused_ops.fused_spmm_ema_shared(ms_, m_p, is_, ps_,
                                                        prep),
                        fused_ops.fused_spmm_ema_shared_plain(ms_, m_p, is_,
                                                              ps_, prep)))
                    ms = _time_ms(lambda: fused_ops.fused_spmm_ema_shared(
                        ms_, m_p, is_, ps_, prep))
                    line("group", tag, dt, ms_[0], m_p, is_[0], ms, ok)
            del m_p, m_as
            torch.cuda.empty_cache()
        del prep
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
