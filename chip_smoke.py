#!/usr/bin/env python
"""On-card smoke test: the MTIP phasing path on NVIDIA GPUs, end to end.

    python chip_smoke.py          # one GPU: every single-card phase
    python chip_smoke.py --four   # four GPUs: the sharded phases only

Single card: the tutorial-width (N_q=128, L_max=64, 256x512 grid) full
600-iteration HIO/ER/shrink-wrap schedule over 2 restarts through
MultiStartRunner; a production-width (N_q=256, L_max=128, 320x640) restart
through CheckpointingRunner with its peak device memory; and the accuracy
checks (a) composed FT vs a float64 host composition, (b) Newton–Schulz
polar factor vs a float64 SVD polar, (c) 20 HIO iterations on the GPU vs the
same jitted program on the CPU: the first stages of one iteration to a
fixed bound, the 20 error curves within the rounding envelope. (a) and (b)
are also printed at the backend's DEFAULT matmul precision, as a finding;
(c) runs at DEFAULT too, as a control its checks must reject. The worker
pipeline phase needs h5py and PyYAML; where either is missing it is reported
as not run.

--four: MultiStartRunner with 8 tutorial-width restarts on a {restarts: 4}
and a {restarts: 2, theta: 2} mesh against the single-card vmapped run of the
same seeds: the first stages of one iteration to a fixed bound, with a
DEFAULT-precision control; the error curves where they end, to
ENDPOINT_TOL. Then the average worker's sharded alignment against the
unsharded one.

Every line but the last starts with the cards' name and power limit
(nvidia-smi). The last line is one JSON object
{"ok": true, "device": {"platform", "kind", "count"}}. Without a GPU, or when
any phase fails, the script exits nonzero and prints no such line.
"""
import argparse
import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# tolerances, each with its reason
FT_TOL = 2e-6          # (a) composed FT rel. L2; the CPU pin is 1e-6/2e-6
NS_UNITARITY_TOL = 1e-5  # (b) ‖W†W − I‖₂; the minimax schedule targets 1e-6
NS_POLAR_TOL = 1e-3    # (b) rel. Frobenius distance to the SVD polar factor
                       #     (f32 rounding amplified by 1/σ_min = 1e3)
HIO_TOL = 1e-4         # (c) GPU vs CPU error curves, relative, where the
                       #     rounding envelope is below ENVELOPE_SPLIT
ENVELOPE_SPLIT = 1e-5  # 5x the composed-FT gate: beyond it HIO has already
                       #     amplified rounding past what one FT leaves
ENVELOPE_FACTOR = 10   # elsewhere within 10x the envelope: the largest ratio
                       #     read on the card was 2.3 (CPU, 20 iterations)
STAGE_TOL = 2e-6       # FT(ρ) and the intensity's harmonic coefficients,
                       #     rel. L2: the composed-FT gate; neither stage
                       #     amplifies rounding
ENDPOINT_TOL = 0.1     # --four: errors after the last iteration, relative
                       #     to the single card. A mesh changes rounding (the
                       #     θ split, the per-card batch), which HIO amplifies
                       #     chaotically, so the curves are compared only
                       #     where they end


def fmt(values):
    """One-line rendering of a per-iteration array."""
    return "[" + " ".join(f"{v:.2e}" for v in np.ravel(values)) + "]"


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rounding_envelope(run, r0, e_ref, device):
    """Per-iteration running maximum of the relative error-curve change that
    a 1e-7 relative perturbation of the input causes in the same program on
    the same device: how far rounding alone moves these curves. HIO is
    sensitive to rounding — a 1e-7 change grows ~10x per early iteration —
    so two backends that round differently cannot agree to a fixed bound
    over many iterations, only to this envelope."""
    import jax
    e1 = np.asarray(run(jax.device_put(perturbed(r0), device))[1])
    rel = (np.abs(e1 - e_ref) / np.abs(e_ref)).max(axis=(0, 2))
    return np.maximum.accumulate(rel)


def check_against_envelope(rel, env):
    """Iterations the rounding envelope leaves below ENVELOPE_SPLIT must
    agree to HIO_TOL; every iteration must stay within
    max(HIO_TOL, ENVELOPE_FACTOR × envelope)."""
    tight = env <= ENVELOPE_SPLIT
    check((rel[tight] <= HIO_TOL).all(),
          f"error curves differ by more than {HIO_TOL:g} where rounding "
          f"moves them by at most {ENVELOPE_SPLIT:g}: {fmt(rel)}")
    bound = np.maximum(HIO_TOL, ENVELOPE_FACTOR * env)
    check((rel <= bound).all(),
          f"error curves differ beyond {ENVELOPE_FACTOR}x the rounding "
          f"envelope: {fmt(rel)} vs {fmt(env)}")


def rel_l2(a, b):
    """Relative L2 distance of a from the reference b, over all restarts."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def stages_fn(p):
    """Batched ρ → the first stages of one MTIP iteration: ψ = FT(ρ), the
    harmonic coefficients I_lm of |ψ|², and their Procrustes projection.
    The first two only round; the projection is a polar factor, whose
    conditioning amplifies a change of its input several hundred fold."""
    import jax

    def stages(rho):
        psi = p.ft.forward(rho)
        ilm = p.mtip.sht.forward_real((psi * psi.conj()).real)
        return {"FT": psi, "I_lm": ilm, "projected I_lm": p.mtip.rc(ilm)}

    return jax.vmap(stages)


def compare_stages(say, label, out, ref, out_default, response):
    """Stage by stage relative L2 of `out` from `ref`. FT and I_lm must agree
    to STAGE_TOL, and the same program with every product at DEFAULT
    precision (TF32 on the card) must not: the bound can tell a wrong program
    from a right one. The projected I_lm must stay within ENVELOPE_FACTOR ×
    `response`, its change under a 1e-7 input perturbation."""
    d = {k: rel_l2(out[k], ref[k]) for k in ref}
    d_lo = {k: rel_l2(out_default[k], ref[k]) for k in ref}
    say(f"{label}: relative L2 per stage " + ", ".join(
        f"{k} {d[k]:.3e}" for k in d) + f"; response of the projected I_lm "
        f"to a 1e-7 input change {response:.3e}; control at DEFAULT "
        f"precision " + ", ".join(f"{k} {d_lo[k]:.3e}" for k in d_lo))
    for k in ("FT", "I_lm"):
        check(d[k] <= STAGE_TOL, f"{k} differs by {d[k]:.3e} (limit "
              f"{STAGE_TOL:g})")
        check(d_lo[k] > STAGE_TOL, f"control not rejected: {k} at DEFAULT "
              f"precision differs by only {d_lo[k]:.3e}")
    k = "projected I_lm"
    check(d[k] <= ENVELOPE_FACTOR * response, f"{k} differs by {d[k]:.3e}, "
          f"beyond {ENVELOPE_FACTOR}x its rounding response {response:.3e}")


def perturbed(r0):
    """r0 with a 1e-7 relative perturbation (fixed seed)."""
    rng = np.random.default_rng(7)
    return (r0 * (1 + 1e-7 * rng.standard_normal(r0.shape))).astype(r0.dtype)


class NotRun(str):
    """Returned by a phase that could not run here; the text says why."""


class Smoke:
    def __init__(self, card):
        self.card = card
        self.failed = []
        self.cache = {}

    def say(self, msg):
        print(f"[{self.card}] {msg}", flush=True)

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            result = fn()
        except Exception as e:  # report every phase, then fail the run
            traceback.print_exc()
            self.failed.append(name)
            self.say(f"{name}: FAILED {type(e).__name__}: {e} "
                     f"({time.perf_counter() - t0:.1f} s)")
            return
        if isinstance(result, NotRun):
            self.say(f"{name}: not run — {result}")
            return
        self.say(f"{name}: ok ({time.perf_counter() - t0:.1f} s)")

    # ----------------------------------------------------------- problems
    def tutorial(self):
        if "tut" not in self.cache:
            from xframe_tpu.ops.polar_schedule import DEFAULT_SCHEDULE
            from xframe_tpu.projects.fxs.demo import make_demo_problem
            self.cache["tut"] = make_demo_problem(
                128, 64, n_theta=256, n_phi=512,
                procrustes_method="newton_schulz",
                ns_schedule=DEFAULT_SCHEDULE)
        return self.cache["tut"]

    # ------------------------------------------------------ single card
    def device(self):
        import jax
        from xframe_tpu.library.device import device_record
        rec = device_record()
        stats = jax.devices()[0].memory_stats() or {}
        self.say(f"device: {rec}, bytes_limit="
                 f"{stats.get('bytes_limit', 'not reported')}")

    def phasing_tutorial(self):
        import jax
        from xframe_tpu.parallel.mesh import MultiStartRunner
        from xframe_tpu.projects.fxs.phasing import tutorial_schedule
        p = self.tutorial()
        sched = tutorial_schedule(p.mtip.sw.default_sigma)
        n_iter = sum(s.n for s in sched if s.method != "SW")
        runner = MultiStartRunner(p.mtip, sched)
        r0 = p.initial_density_batch(0, 2)
        t0 = time.perf_counter()
        states, errors = runner(r0)
        jax.block_until_ready(errors)
        t_first = time.perf_counter() - t0
        r1 = p.initial_density_batch(1, 2)
        jax.block_until_ready(r1)
        t0 = time.perf_counter()
        states, errors = runner(r1)
        jax.block_until_ready((states.best_rho, errors))
        dt = time.perf_counter() - t0
        errors = np.asarray(errors)
        best = np.asarray(states.best_err)
        check(errors.shape == (2, n_iter, 2), f"errors shape {errors.shape}")
        check(np.isfinite(errors).all() and np.isfinite(best).all(),
              "non-finite errors")
        start = errors[:, :5, 0].mean(axis=1)
        check((best < 0.3 * start).all(),
              f"no convergence: best {best} vs start {start}")
        corr = self._ground_truth_corr(p, np.asarray(
            states.best_rho[int(np.argmin(best))]))
        check(corr > 0.8, f"best restart correlates {corr:.3f} with truth")
        self.say(f"phasing tutorial width: 2 restarts x {n_iter} iterations, "
                 f"first call (compile + run) {t_first:.2f} s, timed run "
                 f"{dt:.3f} s = {dt / (n_iter * 2):.6f} s/iteration/restart, "
                 f"{2 * 3600.0 / dt:.1f} restarts/hour; best errors "
                 f"{best.tolist()}, ground-truth correlation {corr:.4f}")

    def _ground_truth_corr(self, p, best_rho):
        """Real-space correlation of a reconstruction with the demo's true
        density after centering and SO(3) alignment (band-capped at 24)."""
        import jax.numpy as jnp
        from xframe_tpu.projects.fxs.alignment import Aligner
        from xframe_tpu.projects.fxs.fidelity import density_correlation
        w = np.asarray(p.integrator._w)
        al = Aligner(p.ft, w, l_max_align=24)
        truth, _ = al.center(jnp.asarray(p.rho_true, dtype=jnp.complex64))
        cand, _ = al.center(jnp.asarray(best_rho))
        aligned, _, _ = al.align(cand, al.coefficients(truth),
                                 check_point_inversion=True)
        return density_correlation(np.asarray(aligned), np.asarray(truth), w)

    def phasing_production(self):
        import jax
        from xframe_tpu.ops.polar_schedule import DEFAULT_SCHEDULE
        from xframe_tpu.parallel.mesh import CheckpointingRunner
        from xframe_tpu.projects.fxs.demo import make_demo_problem
        from xframe_tpu.projects.fxs.phasing import Segment
        t0 = time.perf_counter()
        pp = make_demo_problem(256, 128, n_theta=320, n_phi=640,
                               procrustes_method="newton_schulz",
                               ns_schedule=DEFAULT_SCHEDULE)
        t_setup = time.perf_counter() - t0
        sw = pp.mtip.sw.default_sigma
        sched = [Segment("HIO", 20, betas=np.full(20, 0.5), ft_stab=True),
                 Segment("SW", sigma=sw, threshold=0.1),
                 Segment("ER", 10, betas=np.zeros(10), ft_stab=True)]
        n_iter = 30
        runner = CheckpointingRunner(pp.mtip, sched)
        r0 = pp.initial_density_batch(0, 1, tables=runner._tables)
        t0 = time.perf_counter()
        states, errors = runner(r0, resume=False)
        jax.block_until_ready(errors)
        t_first = time.perf_counter() - t0
        r1 = pp.initial_density_batch(1, 1, tables=runner._tables)
        jax.block_until_ready(r1)
        t0 = time.perf_counter()
        states, errors = runner(r1, resume=False)
        jax.block_until_ready((states.best_rho, errors))
        dt = time.perf_counter() - t0
        errors = np.asarray(errors)
        best = np.asarray(states.best_err)
        check(errors.shape == (1, n_iter, 2), f"errors shape {errors.shape}")
        check(np.isfinite(errors).all(), "non-finite errors")
        check(best[0] < errors[0, 0, 0], "no progress")
        peak = (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use")
        self.say(f"phasing production width (N_q=256, L=128, 320x640): "
                 f"1 restart x {n_iter} iterations, host setup "
                 f"{t_setup:.1f} s, first call {t_first:.2f} s, timed run "
                 f"{dt:.3f} s = {dt / n_iter:.6f} s/iteration/restart; "
                 f"best error {best[0]:.4e}; peak_bytes_in_use {peak}")

    def check_a(self):
        import jax
        from jax import lax
        sys.path.insert(0, os.path.join(HERE, "scripts"))
        from sht_accuracy import composed_ft_accuracy
        from xframe_tpu.library.jaxpr_precision import with_precision
        ft = self.tutorial().ft
        hi = composed_ft_accuracy(ft)
        lo = composed_ft_accuracy(ft, forward_and_roundtrip=jax.jit(
            with_precision(ft.forward_and_roundtrip,
                           lax.Precision.DEFAULT)))
        self.say(f"(a) composed FT vs float64 at tutorial width, HIGHEST: "
                 f"forward {hi['forward']:.3e}, roundtrip "
                 f"{hi['roundtrip']:.3e}, defect gap {hi['defect_gap']:.3e} "
                 f"(limit {FT_TOL:g})")
        self.say(f"(a) finding, DEFAULT precision: forward "
                 f"{lo['forward']:.3e}, roundtrip {lo['roundtrip']:.3e}")
        check(hi["forward"] <= FT_TOL and hi["roundtrip"] <= FT_TOL,
              f"composed FT error {hi}")

    def check_b(self):
        import jax
        from jax import lax
        from xframe_tpu.library.jaxpr_precision import with_precision
        from xframe_tpu.ops.polar_schedule import DEFAULT_SCHEDULE
        from xframe_tpu.projects.fxs.projections import (
            polar_unitary_newton_schulz)
        # tutorial width: L+1 = 65 orders of (2L+1)² = 129² blocks, singular
        # values log-uniform in [1e-3, 1], exact polar factor U V† in f64
        rng = np.random.default_rng(0)
        b, n = 65, 129

        def haar(k):
            z = rng.standard_normal((k, n, n)) \
                + 1j * rng.standard_normal((k, n, n))
            q, r = np.linalg.qr(z)
            d = np.diagonal(r, axis1=1, axis2=2)
            return q * (d / np.abs(d))[:, None, :]

        U, V = haar(b), haar(b)
        s = np.exp(rng.uniform(np.log(1e-3), 0.0, (b, n)))
        M = np.einsum("bij,bj,bkj->bik", U, s, V.conj()).astype(np.complex64)
        W_ref = np.einsum("bij,bkj->bik", U, V.conj())

        def polar(m):
            return polar_unitary_newton_schulz(m, schedule=DEFAULT_SCHEDULE)

        def measure(fn):
            W = np.asarray(jax.jit(fn)(M)).astype(np.complex128)
            E = np.einsum("bji,bjk->bik", W.conj(), W) - np.eye(n)
            unit = max(np.linalg.norm(e, 2) for e in E)
            dist = np.linalg.norm(W - W_ref) / np.linalg.norm(W_ref)
            return unit, dist

        unit, dist = measure(polar)
        unit_d, dist_d = measure(with_precision(polar, lax.Precision.DEFAULT))
        self.say(f"(b) Newton-Schulz polar vs float64 SVD polar, 65 x "
                 f"129^2, HIGHEST: unitarity {unit:.3e} (limit "
                 f"{NS_UNITARITY_TOL:g}), distance {dist:.3e} (limit "
                 f"{NS_POLAR_TOL:g})")
        self.say(f"(b) finding, DEFAULT precision: unitarity {unit_d:.3e}, "
                 f"distance {dist_d:.3e}")
        check(unit <= NS_UNITARITY_TOL and dist <= NS_POLAR_TOL,
              f"NS polar unitarity {unit}, distance {dist}")

    def check_c(self):
        import jax
        from jax import lax
        from xframe_tpu.library.jaxpr_precision import with_precision
        from xframe_tpu.projects.fxs.phasing import Segment
        p = self.tutorial()
        sched = [Segment("HIO", 20, betas=np.full(20, 0.5), ft_stab=True)]

        def hio20(r):
            return p.mtip.run_batch(r, sched)

        r0 = np.asarray(p.initial_density_batch(2, 1))
        gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
        on_gpu, on_cpu = jax.device_put(r0, gpu), jax.device_put(r0, cpu)
        lo = lax.Precision.DEFAULT

        stages = jax.jit(stages_fn(p))
        ref = stages(on_cpu)
        response = rel_l2(stages(jax.device_put(perturbed(r0), cpu))[
            "projected I_lm"], ref["projected I_lm"])
        compare_stages(self.say, "(c) first stages of one iteration, GPU vs "
                       "CPU", stages(on_gpu), ref,
                       jax.jit(with_precision(stages_fn(p), lo))(on_gpu),
                       response)

        run = jax.jit(hio20)
        e_gpu = np.asarray(run(on_gpu)[1])
        e_cpu = np.asarray(run(on_cpu)[1])
        env = rounding_envelope(run, r0, e_cpu, cpu)
        rel = (np.abs(e_gpu - e_cpu) / np.abs(e_cpu)).max(axis=(0, 2))
        self.say(f"(c) 20 HIO iterations GPU vs CPU, tutorial width, "
                 f"per-iteration max relative difference of the error "
                 f"curves: {fmt(rel)}; CPU rounding envelope (same program, "
                 f"input perturbed by 1e-7): {fmt(env)}")
        check(np.isfinite(e_gpu).all(), "non-finite GPU errors")
        check_against_envelope(rel, env)
        e_lo = np.asarray(jax.jit(with_precision(hio20, lo))(on_gpu)[1])
        rel_lo = (np.abs(e_lo - e_cpu) / np.abs(e_cpu)).max(axis=(0, 2))
        try:
            check_against_envelope(rel_lo, env)
            verdict = "passed"
        except AssertionError:
            verdict = "FAILED, as it must"
        self.say(f"(c) control, the 20 iterations at DEFAULT precision on "
                 f"the GPU: {fmt(rel_lo)} — the envelope check {verdict}")
        check(verdict != "passed",
              "control not rejected: the envelope check passes a DEFAULT-"
              "precision run")

    def worker_pipeline(self):
        missing = [m for m in ("h5py", "yaml")
                   if importlib.util.find_spec(m) is None]
        if missing:
            return NotRun(
                f"module {', '.join(repr(m) for m in missing)} is not "
                f"installed on this machine (simulate_ccd, extract, "
                f"reconstruct and average store their results as HDF5)")
        raise NotImplementedError(
            "h5py and PyYAML are installed: the worker-pipeline phase "
            "(simulate_ccd -> extract -> reconstruct -> average with the "
            "fidelity gate) is required here and not yet written")

    # -------------------------------------------------------- four cards
    def sharded_restarts(self):
        import jax
        from jax import lax
        from xframe_tpu.library.jaxpr_precision import with_precision
        from xframe_tpu.parallel.mesh import make_mesh, MultiStartRunner
        from xframe_tpu.projects.fxs.phasing import Segment
        p = self.tutorial()
        sw = p.mtip.sw.default_sigma
        sched = [Segment("HIO", 10, betas=np.full(10, 0.5), ft_stab=True),
                 Segment("SW", sigma=sw, threshold=0.1),
                 Segment("ER", 5, betas=np.zeros(5), ft_stab=True)]
        r0 = np.asarray(p.initial_density_batch(0, 8))
        card0 = jax.devices()[0]
        ref_e = np.asarray(MultiStartRunner(p.mtip, sched)(r0)[1])
        stages = jax.jit(stages_fn(p))
        ref = stages(jax.device_put(r0, card0))
        response = rel_l2(stages(jax.device_put(perturbed(r0), card0))[
            "projected I_lm"], ref["projected I_lm"])
        ref_lo = jax.jit(with_precision(stages_fn(p), lax.Precision.DEFAULT))(
            jax.device_put(r0, card0))
        for axes in ({"restarts": 4}, {"restarts": 2, "theta": 2}):
            mesh = make_mesh(axes)
            sharding = MultiStartRunner(p.mtip, sched, mesh).in_sharding
            compare_stages(self.say, f"mesh {axes}: first stages of one "
                           f"iteration vs the single card",
                           stages(jax.device_put(r0, sharding)), ref, ref_lo,
                           response)
            states, errors = MultiStartRunner(p.mtip, sched, mesh)(r0)
            jax.block_until_ready(errors)
            shards = sorted(
                (s.index[0].start or 0, s.index[0].stop, str(s.device))
                for s in states.best_rho.addressable_shards)
            self.say(f"mesh {axes}: restart shards (start, stop, device) "
                     f"{shards}")
            check(len({d for _, _, d in shards}) == 4,
                  "restart shards do not span four devices")
            errors = np.asarray(errors)
            check(np.isfinite(errors).all(), "non-finite errors")
            rel = (np.abs(errors - ref_e) / np.abs(ref_e)).max(axis=(0, 2))
            self.say(f"mesh {axes}: 8 restarts x 15 iterations vs the "
                     f"single-card run, per-iteration max relative "
                     f"difference {fmt(rel)}")
            check(rel[-1] <= ENDPOINT_TOL, f"the sharded run ends "
                  f"{rel[-1]:.3e} away from the single card (limit "
                  f"{ENDPOINT_TOL:g})")

    def sharded_alignment(self):
        import jax
        import jax.numpy as jnp
        from xframe_tpu.parallel.mesh import make_mesh
        from xframe_tpu.projects.fxs.alignment import Aligner
        from xframe_tpu.ops.so3 import wigner_D_single, rotate_coeff
        p = self.tutorial()
        w = np.asarray(p.integrator._w)
        al = Aligner(p.ft, w, l_max_align=24)
        al_m = Aligner(p.ft, w, l_max_align=24,
                       mesh=make_mesh({"restarts": 4}))
        ref = jnp.asarray(p.rho_true, dtype=jnp.complex64)
        ref_coeff = al.coefficients(ref)
        rng = np.random.default_rng(0)
        cands = []
        for k in range(6):       # 6 candidates on 4 cards: padding + trim
            ang = rng.uniform(0, 2 * np.pi), rng.uniform(0, np.pi), \
                rng.uniform(0, 2 * np.pi)
            D = jnp.asarray(wigner_D_single(p.ft.sht.l_max, *ang),
                            dtype=jnp.complex64)
            c = rotate_coeff(al.coefficients(ref), D)
            if k % 2:
                c = al.invert_parity(c)
            cands.append(al._synth(c))
        cands = jnp.stack(cands)
        r0, _, l0, i0 = al.align_batch(cands, ref_coeff, ref_rho=ref)
        r1, _, l1, i1 = al_m.align_batch(cands, ref_coeff, ref_rho=ref)
        jax.block_until_ready(r1)
        d = float(np.abs(np.asarray(r0) - np.asarray(r1)).max())
        same = all(np.allclose(a["angles"], b["angles"])
                   and a["inverted"] == b["inverted"] for a, b in zip(i0, i1))
        self.say(f"sharded alignment (6 candidates, 4 cards): max density "
                 f"difference {d:.3e}, l2 difference "
                 f"{float(np.abs(np.asarray(l0) - np.asarray(l1)).max()):.3e}"
                 f", same rotations: {same}")
        check(same and d < 1e-4 * float(np.abs(np.asarray(r0)).max()),
              "sharded alignment differs from unsharded")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phases")
    args = ap.parse_args()

    from xframe_tpu.library.compile_cache import enable as enable_cache
    from xframe_tpu.library.device import (NoGPUError, card_line,
                                           device_record, require_gpu)
    try:
        devices = require_gpu()
    except NoGPUError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 2
    if not args.four:
        devices = devices[:1]
    enable_cache()
    smoke = Smoke(card_line())
    if args.four:
        phases = [("sharded restarts", smoke.sharded_restarts),
                  ("sharded alignment", smoke.sharded_alignment)]
    else:
        phases = [("device check", smoke.device),
                  ("phasing, tutorial width", smoke.phasing_tutorial),
                  ("phasing, production width", smoke.phasing_production),
                  ("check (a)", smoke.check_a),
                  ("check (b)", smoke.check_b),
                  ("check (c)", smoke.check_c),
                  ("worker pipeline", smoke.worker_pipeline)]
    for name, fn in phases:
        smoke.phase(name, fn)
    if smoke.failed:
        smoke.say(f"FAILED phases: {smoke.failed}")
        return 1
    smoke.say(smoke.card)
    print(json.dumps({"ok": True, "device": device_record(devices)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
