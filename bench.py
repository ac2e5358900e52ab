#!/usr/bin/env python
"""Phasing throughput on one GPU: seconds per MTIP iteration per restart.

Three measurements of the plain jnp path through the runners the workers
use, at the reference tutorial width (N_q=128, L_max=64, 256×512 angular
grid — BASELINE.md) unless stated:

1. a window of XF_BENCH_ITERS HIO iterations over XF_BENCH_RESTARTS restarts
   (MultiStartRunner);
2. the full 600-iteration tutorial schedule with shrink-wrap, as restarts
   per hour (MultiStartRunner; skip with XF_BENCH_NO_FULL=1);
3. that schedule at production width (N_q=256, L_max=128, 320×640) through
   the chunked CheckpointingRunner (skip with XF_BENCH_NO_PROD=1).

Baseline: the reference's amortized 1.2 s/iteration per restart stream and
285 restarts/hour (57 restarts, EPYC 7543 + 2× RTX A6000 OpenCL;
docs/fxs.md:482-484). Prints ONE JSON line naming the device and the card's
power limit; exits nonzero without a GPU.

    python bench.py
    python bench.py --trace DIR   # also profile 10 HIO iterations and print
                                  # the top device operations
"""
import argparse
import json
import os
import sys
import time

import numpy as np

BASELINE_SEC_PER_ITER = 1.2
BASELINE_RESTARTS_PER_HOUR = 285.0


def top_device_ops(trace_dir, n=15):
    """Reduce the newest jax.profiler trace under trace_dir: per device
    plane, the n operations with the largest summed device time, and the
    device busy time (union of operation intervals) over the traced window.
    → {plane: {"window_ns", "busy_ns", "lines", "top": [(name, ns, count)]}}"""
    import glob
    from jax.profiler import ProfileData
    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    pd = ProfileData.from_file(paths[-1])
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or lines
        totals, spans = {}, []
        for ln in ops:
            for ev in ln.events:
                t, c = totals.get(ev.name, (0, 0))
                totals[ev.name] = (t + ev.duration_ns, c + 1)
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
        spans.sort()
        busy, end = 0, None
        for s, e in spans:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        window = (spans[-1][1] - spans[0][0]) if spans else 0
        top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:n]
        out[plane.name] = {"window_ns": window, "busy_ns": busy,
                           "lines": [ln.name for ln in lines],
                           "top": [(k, v[0], v[1]) for k, v in top]}
    return out


def main():
    ap = argparse.ArgumentParser(description="MTIP phasing throughput")
    ap.add_argument("--trace", metavar="DIR",
                    help="profile a 10-iteration window into DIR")
    args = ap.parse_args()

    import jax
    from xframe_tpu.library.compile_cache import enable as enable_cache
    from xframe_tpu.library.device import (NoGPUError, card_line,
                                           device_record, require_gpu)
    try:
        devices = require_gpu()
    except NoGPUError as e:
        print(json.dumps({"metric": "sec_per_mtip_iteration_tutorial",
                          "value": None, "error": str(e)}))
        return 2
    enable_cache()
    from xframe_tpu.ops.polar_schedule import DEFAULT_SCHEDULE
    from xframe_tpu.parallel.mesh import CheckpointingRunner, MultiStartRunner
    from xframe_tpu.projects.fxs.demo import make_demo_problem
    from xframe_tpu.projects.fxs.phasing import Segment, tutorial_schedule

    n_restarts = int(os.environ.get("XF_BENCH_RESTARTS", "2"))
    n_iter = int(os.environ.get("XF_BENCH_ITERS", "100"))
    p = make_demo_problem(128, 64, n_theta=256, n_phi=512,
                          procrustes_method="newton_schulz",
                          ns_schedule=DEFAULT_SCHEDULE)
    schedule = [Segment("HIO", n_iter, betas=np.full(n_iter, 0.5),
                        ft_stab=True)]
    rho0s = p.initial_density_batch(0, n_restarts)
    run = MultiStartRunner(p.mtip, schedule)
    states, errors = run(rho0s)          # compile + warmup
    jax.block_until_ready((states.rho, errors))
    rho0s_b = p.initial_density_batch(1, n_restarts)
    jax.block_until_ready(rho0s_b)       # keep input prep out of the timing
    t0 = time.perf_counter()
    states, errors = run(rho0s_b)
    jax.block_until_ready((states.rho, errors))
    dt = time.perf_counter() - t0
    sec_per_iter = dt / (n_iter * n_restarts)
    out = {
        "metric": "sec_per_mtip_iteration_tutorial",
        "value": sec_per_iter,
        "unit": "s/iteration/restart (N_q=128, L_max=64, 256x512 "
                "angular grid)",
        "vs_baseline": BASELINE_SEC_PER_ITER / sec_per_iter,
        "restarts": n_restarts,
        "device": device_record(devices[:1]),
        "card": card_line(),
    }

    if args.trace:
        short = [Segment("HIO", 10, betas=np.full(10, 0.5), ft_stab=True)]
        run_s = MultiStartRunner(p.mtip, short)
        jax.block_until_ready(run_s(rho0s)[1])
        jax.profiler.start_trace(args.trace)
        jax.block_until_ready(run_s(rho0s_b)[1])
        jax.profiler.stop_trace()
        red = top_device_ops(args.trace)
        for plane, r in red.items():
            print(f"{plane}: window {r['window_ns'] / 1e6:.3f} ms, busy "
                  f"{r['busy_ns'] / 1e6:.3f} ms, lines {r['lines']}",
                  file=sys.stderr)
            for name, ns, count in r["top"]:
                print(f"  {ns / 1e6:10.3f} ms  {count:6d}x  {name[:110]}",
                      file=sys.stderr)
        out["trace"] = {k: {"window_ms": v["window_ns"] / 1e6,
                            "busy_ms": v["busy_ns"] / 1e6}
                        for k, v in red.items()}

    if not os.environ.get("XF_BENCH_NO_FULL"):
        full = tutorial_schedule(p.mtip.sw.default_sigma)
        run_full = MultiStartRunner(p.mtip, full)
        states_f, errs = run_full(rho0s)    # compile + warmup
        jax.block_until_ready((states_f.rho, errs))
        t0 = time.perf_counter()
        states_f, errs = run_full(rho0s_b)
        jax.block_until_ready((states_f.rho, errs))
        dt_full = time.perf_counter() - t0
        n_full = sum(s.n for s in full if s.method != "SW")
        rph = n_restarts * 3600.0 / dt_full
        out["full_schedule_restarts_per_hour"] = rph
        out["full_schedule"] = {
            "iterations": n_full, "restarts": n_restarts,
            "seconds": dt_full, "restarts_per_hour": rph,
            "vs_baseline_restarts_per_hour": rph / BASELINE_RESTARTS_PER_HOUR,
        }

    if not os.environ.get("XF_BENCH_NO_PROD"):
        nq_p, L_p, nth, nph = 256, 128, 320, 640
        pp = make_demo_problem(nq_p, L_p, n_theta=nth, n_phi=nph,
                               procrustes_method="newton_schulz",
                               ns_schedule=DEFAULT_SCHEDULE)
        sched_p = tutorial_schedule(pp.mtip.sw.default_sigma)
        n_p = sum(s.n for s in sched_p if s.method != "SW")
        runner = CheckpointingRunner(pp.mtip, sched_p)
        r0 = pp.initial_density_batch(0, 1, tables=runner._tables)
        jax.block_until_ready(runner(r0, resume=False)[1])  # compile + warmup
        r1 = pp.initial_density_batch(1, 1, tables=runner._tables)
        jax.block_until_ready(r1)
        t0 = time.perf_counter()
        states_p, errs_p = runner(r1, resume=False)
        jax.block_until_ready((states_p.best_rho, errs_p))
        dt_p = time.perf_counter() - t0
        out["production_full_schedule_restarts_per_hour"] = 3600.0 / dt_p
        out["production"] = {
            "sec_per_iteration": dt_p / n_p,
            "seconds_per_restart": dt_p,
            "restarts_per_hour": 3600.0 / dt_p,
            "unit": f"s/iteration/restart (N_q={nq_p}, L_max={L_p}, "
                    f"{nth}x{nph} angular grid, full 600-iter schedule)",
            "best_err": float(np.asarray(states_p.best_err)[0]),
            "peak_bytes_in_use": (jax.devices()[0].memory_stats() or {})
            .get("peak_bytes_in_use"),
        }

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
