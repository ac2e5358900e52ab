"""The MTIP phasing loop, jit-compiled end-to-end on device.

This replaces the reference's RecipeFactory-compiled operator graph + fork-based
multi-start + OpenCL kernel RPC (reconstruct.py:488-1036, SURVEY.md §3.1) with:

  * one pure function per MTIP iteration (2 spherical FTs + 1 intensity-SHT
    pair + batched per-l Procrustes + elementwise projections),
  * `lax.scan` over contiguous HIO/ER/RAAR runs with per-step β arrays
    (ramps flattened on host — the schedule is static),
  * shrink-wrap support updates between scans,
  * `vmap` over the multi-start restart axis; sharded over a device mesh by
    the caller (see parallel.mesh).

The iteration schedule (sub_loops / methods / ramps) is flattened from the
settings tree into a list of Segment records at setup time, mirroring
assemble_phasing_loop (reconstruct.py:768-1036) including β ramps per loop,
shrink-wrap σ/threshold ramps, the error-gated `enforce_initial_support`
rule, and the `ft_stab` round-trip compensation (reconstruct.py:585-595).
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from functools import partial
from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from xframe_tpu.library.ramps import ExponentialRamp, LinearRamp
from xframe_tpu.projects.fxs.projections import (
    RealConstraint, ShrinkWrap,
    project_to_modified_intensity, hio_update, er_update, raar_update,
)

@dataclass
class Segment:
    """One contiguous run of a single method in the flattened schedule."""
    method: str                 # 'HIO' | 'ER' | 'RAAR' | 'SW'
    n: int = 1
    betas: Any = None           # (n,) float array for HIO/RAAR
    ft_stab: bool = False
    sigma: float = 0.0          # SW gaussian sigma
    threshold: float = 0.0      # SW relative threshold
    # dynamic ft_stab (reference 'link_to_enforce_initial_support',
    # reconstruct.py:836-850): when > 0, ft_stab applies iff at least
    # `delay` shrink-wrap events have happened AND none of the last `delay`
    # enforced the initial support. ft_stab must be True (the compiled
    # structure); the runtime gate multiplies the correction by 0/1.
    ft_stab_link_delay: int = 0


def build_schedule(main_loop_opt, hio_beta_opt, sw_sigmas_opt, sw_thresholds_opt,
                   method_ft_stab, default_sigma):
    """Flatten the sub-loops tree into Segments (assemble_phasing_loop semantics).

    main_loop_opt: {'order': [names], name: {'iterations': int, 'order': [...],
                    'methods': {m: {'iterations': int} | int}}}
    hio_beta_opt: list of [start, stop, exponent, stop_arg] per loop
    sw_sigmas_opt / sw_thresholds_opt: per-loop LinearRamp specs
    method_ft_stab: {loop_name: {method: bool}}
    """
    segments = []
    for loop_id, loop_name in enumerate(main_loop_opt['order']):
        loop = main_loop_opt[loop_name]
        beta_spec = hio_beta_opt[loop_id] if loop_id < len(hio_beta_opt) \
            else [0.5, 0.5, -1 / 700, 1600]
        beta_ramp = ExponentialRamp(*beta_spec)
        sigma_spec = sw_sigmas_opt[loop_id] if loop_id < len(sw_sigmas_opt) else False
        if not isinstance(sigma_spec, (list, tuple)):
            sigma_spec = [sigma_spec]
        sigma_ramp = LinearRamp(*sigma_spec, default_start=default_sigma,
                                default_stop=default_sigma)
        th_spec = sw_thresholds_opt[loop_id] if loop_id < len(sw_thresholds_opt) else 0.1
        if not isinstance(th_spec, (list, tuple)):
            th_spec = [th_spec]
        th_ramp = LinearRamp(*th_spec)

        def ramp_val(ramp, x, default):
            v = ramp(x)
            return default if (ramp.undefined or not np.isfinite(v)) else float(v)

        step = 0      # counts HIO/ER repeats within this loop (β argument)
        sw_step = 0   # counts SW events within this loop (σ/threshold argument)
        # best_density_not_in_first_n_iterations (reference
        # reconstruct.py:945-951): after this loop, continue from the best
        # state found — unless the best stems from 1-based sub-loop iteration
        # ≤ n (the reference loops `for iteration in range(1, max+1)` and
        # resets when best_iteration > n). Realized as a SNAPSHOT of best_err
        # BEFORE 0-based iteration n (== after 1-based iteration n; before
        # any iteration for n == 0) plus a RESET_TO_BEST at loop end (strict
        # improvements make "best found later than n" ⟺ "best_err dropped
        # below the snapshot"). Known deviation: the reference compares the
        # carried best_iteration even when the best stems from a PREVIOUS
        # sub-loop, comparing iteration indices across different loops; the
        # snapshot form only resets on improvements within this loop.
        n_first = loop.get('best_density_not_in_first_n_iterations', None) \
            if hasattr(loop, 'get') else None
        if n_first is not None and (n_first is False
                                    or not np.isfinite(float(n_first))):
            n_first = None
        n_iters = int(loop['iterations'])
        if n_first is not None and int(n_first) >= n_iters:
            n_first = None
        for it in range(n_iters):
            if n_first is not None and it == int(n_first):
                segments.append(Segment(method='SNAPSHOT'))
            for method in loop['order']:
                mopt = loop['methods'][method]
                if hasattr(mopt, 'get'):  # dict or DictNamespace node
                    repeats = int(mopt.get('iterations', 0))
                else:
                    repeats = int(mopt)
                if method in ('SW', 'SW_center'):
                    for _ in range(repeats):
                        segments.append(Segment(
                            method=method,
                            sigma=ramp_val(sigma_ramp, sw_step, default_sigma),
                            threshold=ramp_val(th_ramp, sw_step, 0.1)))
                        sw_step += 1
                else:
                    base = method.replace('_non_FXS', '')
                    betas = np.array([beta_ramp(step + i) for i in range(repeats)],
                                     dtype=np.float64)
                    step += repeats
                    # per-method ft_stab (reference methods.<m>.ft_stab,
                    # reconstruct.py:836-850) wins over the rebuild's
                    # main_loop.ft_stabilization {loop: {method: bool}} map.
                    fts = mopt.get('ft_stab', None) \
                        if hasattr(mopt, 'get') else None
                    link_delay = 0
                    if isinstance(fts, str):
                        if fts != 'link_to_enforce_initial_support':
                            raise ValueError(
                                f"unknown ft_stab mode {fts!r} for {method}")
                        # reference: delay = max(int(opts.link_to_enforce_
                        # initial_support.delay), 1) (reconstruct.py:844);
                        # ft_stab applies iff >= delay SW events exist and
                        # NONE of the last `delay` enforced the initial
                        # support — realized as a runtime 0/1 gate on the
                        # compiled ft-stab structure (carried enforce
                        # history, see PhasingState.enforce_hist)
                        link = mopt.get('link_to_enforce_initial_support',
                                        None) if hasattr(mopt, 'get') else None
                        delay = link.get('delay', 1) \
                            if link is not None and hasattr(link, 'get') else 1
                        link_delay = max(int(delay), 1)
                        fts = True
                    if fts is None:
                        fts = bool(method_ft_stab.get(loop_name, {})
                                   .get(method, False))
                    segments.append(Segment(
                        method=base, n=repeats, betas=betas,
                        ft_stab=bool(fts), ft_stab_link_delay=link_delay))
        if n_first is not None:
            segments.append(Segment(method='RESET_TO_BEST'))
    return segments


def tutorial_schedule(sw_sigma):
    """The reference tutorial's main loop (settings reconstruct/tutorial.yaml):
    5×(60 HIO + SW + 40 ER) + SW + 100 ER = 600 iterations, HIO β = 0.5,
    shrink-wrap threshold 0.1, ft-stabilized throughout."""
    sched = []
    for _ in range(5):
        sched += [Segment("HIO", 60, betas=np.full(60, 0.5), ft_stab=True),
                  Segment("SW", sigma=sw_sigma, threshold=0.1),
                  Segment("ER", 40, betas=np.zeros(40), ft_stab=True)]
    sched += [Segment("SW", sigma=sw_sigma, threshold=0.1),
              Segment("ER", 100, betas=np.zeros(100), ft_stab=True)]
    return sched


class PhasingState(NamedTuple):
    rho: Any
    support: Any
    best_rho: Any
    best_mask: Any
    best_err: Any
    last_err: Any
    # best_err snapshot taken by a SNAPSHOT schedule marker (None until one
    # runs): RESET_TO_BEST compares against it to decide whether the best
    # state was found late enough to continue from (reference
    # best_density_not_in_first_n_iterations, reconstruct.py:945-951)
    err_snapshot: Any = None
    # dynamic ft_stab (link_to_enforce_initial_support): boolean history of
    # the last D shrink-wrap enforce flags, newest LAST, initialized all-True
    # (reference: ft_stab stays off until >= delay real SW events exist —
    # padding Trues reproduce that, reconstruct.py:844-849). None unless the
    # schedule contains a linked segment.
    enforce_hist: Any = None


class MTIP:
    """Bundles transforms + constraints into the jittable phasing program."""

    def __init__(self, ft, reciprocal, real: RealConstraint,
                 shrink_wrap: ShrinkWrap, integration_weights, initial_support,
                 enforce_initial_support_limit=np.inf, real_dtype=jnp.float32,
                 harmonic=None, fix_global_phase=True,
                 pn_estimate_in=None, error_config=None):
        """harmonic: intensity↔coefficient transform for the data projection;
        defaults to ft.sht (3D). Pass projections.RealCircularHarmonics for
        the 2D polar pipeline.

        fix_global_phase anchors the global phase gauge each iteration
        (intensities are invariant under ρ → e^{iφ}ρ, so nothing else pins
        φ; the reference relies on its absolute limit_imag threshold, which
        only bites at its particular density scales)."""
        self.ft = ft
        self.sht = harmonic if harmonic is not None else ft.sht
        self.rc = reciprocal
        self.real = real
        self.sw = shrink_wrap
        cdtype = jnp.complex64 if real_dtype == jnp.float32 else jnp.complex128
        self.cdtype = cdtype
        self.rdtype = real_dtype
        np_real = np.float32 if real_dtype == jnp.float32 else np.float64
        # host numpy constants, embedded by jit or bound as arguments.
        # integration_weights may be FULL-GRID (legacy: already masked by the
        # initial support) or any broadcastable shape such as the separable
        # (n_r, n_θ, 1) form (ops.integrate w_broadcast) — then the support
        # masking happens IN-TRACE, so the compiled payload carries only the
        # small factors instead of a grid-sized constant (production scale:
        # the dense masked weights alone are 210 MB at N_q=256/L=128)
        self._w_err_host = np.asarray(integration_weights, dtype=np_real)
        self.initial_support = np.asarray(initial_support)
        self._w_err_premasked = (
            self._w_err_host.shape == self.initial_support.shape)
        # reciprocal-grid integration weights for the reciprocal L2 metric:
        # the reference integrates it over the reciprocal grid
        # (fxs_IO_methods.py:97-128; its cache-aware default path spells
        # _type='reziprocal' at :304 and thus lands on the REAL-grid
        # integrator — harmless, reciprocity-paired radial nodes make both
        # weight sets proportional and the constant cancels in the ratio)
        self._w_rec_host = None
        qs = getattr(ft, "qs", None)
        if qs is not None:
            from xframe_tpu.ops.integrate import (SphericalIntegrator,
                                                  PolarIntegrator)
            shp = self.initial_support.shape
            if self.initial_support.ndim == 3:
                # separable (n_q, n_θ, 1) form — never a grid-sized constant
                self._w_rec_host = np.asarray(SphericalIntegrator(
                    np.asarray(qs), shp[1], shp[2],
                    real_dtype=real_dtype).w_broadcast, dtype=np_real)
            elif self.initial_support.ndim == 2:
                self._w_rec_host = np.asarray(PolarIntegrator(
                    np.asarray(qs), shp[1], real_dtype=real_dtype)._w,
                    dtype=np_real)
        self.enforce_limit = float(enforce_initial_support_limit)
        self.fix_global_phase = bool(fix_global_phase)
        self._r_cart = None
        self._q_cart = None
        # per-iteration particle-number estimation adds a 3rd error column
        self._pn_enabled = bool(getattr(reciprocal, 'pn_enabled', False))
        self._err_cols = 3 if self._pn_enabled else 2
        # restrict estimation to these loop methods (reference
        # number_of_particles.settings.estimate_in, reconstruct.py:560-690);
        # None = all methods
        self._pn_estimate_in = (None if pn_estimate_in is None
                                else tuple(pn_estimate_in))
        # configurable in-loop error metrics (reference main_loop.error
        # methods + main combiner, fxs_IO_methods.py:287-401,746-765;
        # reconstruct.py:796-799). The default reproduces the tutorial:
        # main = mean([real l2_projection_diff inside the initial support]).
        cfg = dict(error_config or {})
        self._err_real_masked = bool(cfg.get("real_inside_initial_support",
                                             True))
        self._real_metrics = tuple(cfg.get("real", ("l2_projection_diff",)))
        self._rec_metrics = tuple(cfg.get("reciprocal", ()))
        main_cfg = cfg.get("main", None) or {}
        mm = main_cfg.get("metrics", None) or {}
        self._main_metrics = (tuple(mm.get("real", ("l2_projection_diff",))),
                              tuple(mm.get("reciprocal", ())))
        self._main_type = str(main_cfg.get("type", "mean"))
        known_real = {"l2_projection_diff"}
        known_rec = {"l2_projection_diff", "deg2_invariant_l2_diff"}
        unknown = ((set(self._real_metrics) | set(self._main_metrics[0]))
                   - known_real) \
            | ((set(self._rec_metrics) | set(self._main_metrics[1]))
               - known_rec)
        if unknown:
            raise ValueError(f"unknown error metrics {sorted(unknown)}; "
                             f"known real={sorted(known_real)}, "
                             f"reciprocal={sorted(known_rec)}")
        self._default_err_cfg = (
            self._err_real_masked
            and self._real_metrics == ("l2_projection_diff",)
            and not self._rec_metrics
            and self._main_metrics == (("l2_projection_diff",), ())
            and self._main_type == "mean")
        self._deg2_ref = None
        if "deg2_invariant_l2_diff" in (set(self._rec_metrics)
                                        | set(self._main_metrics[1])):
            self._deg2_ref = self._build_deg2_ref(
                int(cfg.get("deg2_order", 2)))
        self._err_extra_names = [] if self._default_err_cfg else (
            [f"real_{n}" for n in self._real_metrics]
            + [f"reciprocal_{n}" for n in self._rec_metrics])
        self._err_cols += len(self._err_extra_names)
        # dynamic ft_stab: length of the carried enforce history = max link
        # delay over the FULL schedule (register_schedule_dynamics; 0 = the
        # feature is off and PhasingState.enforce_hist stays None)
        self._link_hist_len = 0

    # -------------------------------------------------- dynamic ft_stab (r5)
    def register_schedule_dynamics(self, schedule):
        """Record the max link_to_enforce_initial_support delay of the FULL
        schedule. Runners call this before chunking — a chunk-local maximum
        would drop history carried across chunks."""
        d = max((int(getattr(s, 'ft_stab_link_delay', 0) or 0)
                 for s in schedule), default=0)
        self._link_hist_len = max(self._link_hist_len, d)
        return self._link_hist_len

    def _init_enforce_hist(self, state, schedule=None):
        """Lazily attach the all-True enforce history when any linked
        segment exists (see PhasingState.enforce_hist)."""
        if schedule is not None:
            self.register_schedule_dynamics(schedule)
        if self._link_hist_len and state.enforce_hist is None:
            lead = jnp.shape(state.last_err)
            state = state._replace(enforce_hist=jnp.ones(
                lead + (self._link_hist_len,), dtype=bool))
        return state

    def _ft_gate(self, state, seg):
        """0/1 runtime gate for a linked segment: 1 iff none of the last
        `delay` shrink-wrap events enforced the initial support (all-True
        padding keeps it 0 until `delay` real events exist)."""
        d = int(getattr(seg, 'ft_stab_link_delay', 0) or 0)
        if not d:
            return None
        hist = state.enforce_hist
        if hist is None:
            raise ValueError(
                "segment has ft_stab_link_delay but the state carries no "
                "enforce history — call register_schedule_dynamics with the "
                "full schedule before running chunks")
        d = min(d, hist.shape[-1])
        return 1.0 - jnp.any(hist[..., -d:], axis=-1).astype(self.rdtype)

    # ------------------------------------------- big tables as jit arguments
    def arg_tables(self):
        """All big numeric tables of the phasing program as a dict of REAL
        host arrays, for threading into jit as ARGUMENTS (see
        ops.fourier.SphericalFourierTransform.arg_tables). Covers the FT's
        Hankel weights and Legendre tables, the reciprocal constraint's
        projection matrices, and the initial support (embedded, each traced
        use became its own grid-sized constant: ~2.2 GB of the tutorial's
        600-iteration program, past what the compile cache can serialize).
        Usage:

            tables = mtip.arg_tables()
            run = jax.jit(lambda t, r: mtip.run_batch(r, schedule, tables=t))
            states, errors = run(tables, rho0s)
        """
        t = self.ft.arg_tables() if hasattr(self.ft, "arg_tables") else {}
        rc = self.rc
        if hasattr(rc, "V_pad"):
            t["rc_V_re"] = np.ascontiguousarray(np.asarray(rc.V_pad).real)
            t["rc_V_im"] = np.ascontiguousarray(np.asarray(rc.V_pad).imag)
            t["rc_PD_re"] = np.ascontiguousarray(np.asarray(rc.PD).real)
            t["rc_PD_im"] = np.ascontiguousarray(np.asarray(rc.PD).imag)
        t["initial_support"] = np.asarray(self.initial_support, dtype=bool)
        return t

    @contextmanager
    def bound_tables(self, tables):
        """Swap the held host tables for traced values during tracing —
        call inside the jitted function; missing entries just stay embedded
        constants (a larger program, never a correctness change)."""
        saves = []

        def swap(obj, attr, val):
            saves.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, val)

        ft_cm = self.ft.bound_tables(tables) \
            if hasattr(self.ft, "bound_tables") else None
        try:
            if ft_cm is not None:
                ft_cm.__enter__()
            if tables and "rc_V_re" in tables:
                swap(self.rc, "V_pad",
                     tables["rc_V_re"] + 1j * tables["rc_V_im"])
                swap(self.rc, "PD",
                     tables["rc_PD_re"] + 1j * tables["rc_PD_im"])
            if tables and "initial_support" in tables:
                swap(self, "initial_support", tables["initial_support"])
            yield
        finally:
            for obj, attr, val in reversed(saves):
                setattr(obj, attr, val)
            if ft_cm is not None:
                ft_cm.__exit__(None, None, None)

    @property
    def _w_err(self):
        """Support-masked error weights, broadcastable to the grid — formed
        in-trace when the host weights are the small separable factors."""
        w = jnp.asarray(self._w_err_host)
        if not self._w_err_premasked:
            w = w * jnp.asarray(self.initial_support, dtype=self.rdtype)
        return w

    # ------------------------------------------------------------- iteration
    def _real_error(self, rho_p, rho_proj):
        """relative L2 projection diff, by default inside the initial support
        (fxs_IO_methods.py:97-129,287-299; the inside_initial_support flag
        maps to main_loop.error.methods.real.l2_projection_diff)."""
        if self._err_real_masked or self._w_err_premasked:
            # premasked legacy weights cannot be unmasked — keep them
            w = self._w_err
        else:
            w = jnp.asarray(self._w_err_host)
        d = rho_p - rho_proj
        num = jnp.sum(w * (d * d.conj()).real)
        den = jnp.sum(w * (rho_p * rho_p.conj()).real)
        return jnp.where(den > 0, num / den, jnp.inf)

    @property
    def error_names(self):
        """Column names of the per-iteration errors array."""
        return (["main", "reciprocal"]
                + (["n_particles"] if self._pn_enabled else [])
                + list(self._err_extra_names))

    def _build_deg2_ref(self, k):
        """Reference B_k = V_k V_k† (masked, order-0 scaled by 1/N) and its
        norm, for the deg2_invariant_l2_diff in-loop metric (reference
        _generate_deg2_invariant_diff_*, fxs_IO_methods.py:384-458)."""
        if hasattr(self.rc, "V_pad"):                     # 3D
            Vk = np.asarray(self.rc.V_pad[k])             # (n_q, n_m)
            B = Vk @ Vk.conj().T
        else:                                             # 2D polar
            vk = np.asarray(self.rc.V[k]).reshape(-1)
            B = np.outer(vk, vk.conj())
        if k == 0:
            # order 0 scales by 1/N (reference invariant_error, :393)
            B = B / float(self.rc.n_particles)
        rmask = np.asarray(self.rc.radial_mask[k]).reshape(-1)
        m2 = rmask[:, None] & rmask[None, :]
        B = B * m2
        norm = float((B * B.conj()).real.sum())
        return (int(k), jnp.asarray(B, dtype=self.cdtype), jnp.asarray(m2),
                norm if norm > 0 else float("inf"))

    def _deg2_error(self, Ilm):
        """Relative L2 diff of the iterate's order-k invariant against the
        data's (reference deg2_invariant_l2_diff with `order: k`)."""
        k, B_ref, m2, norm = self._deg2_ref
        Ik = Ilm[:, :, k] if Ilm.ndim == 3 else Ilm[:, k: k + 1]
        Bk = jnp.matmul(Ik, Ik.conj().T, precision="highest") * m2
        d = B_ref - Bk
        return jnp.sum((d * d.conj()).real) / norm

    def _reciprocal_error(self, psi, psi_p):
        """relative L2 distance of the amplitude projection, integrated with
        the reciprocal-grid weights (fxs_IO_methods.py reciprocal metric
        :97-128; oracle-tested in tests/test_reference_oracle_phasing.py)."""
        d = psi - psi_p
        w = 1.0 if self._w_rec_host is None else jnp.asarray(self._w_rec_host)
        num = jnp.sum(w * (d * d.conj()).real)
        den = jnp.sum(w * (psi * psi.conj()).real)
        return jnp.where(den > 0, num / den, jnp.inf)

    def enable_centering(self, r_cart, q_cart):
        """Provide cartesian grid tables enabling the SW_center variant
        (shrink-wrap + center-of-mass shift, reference SW_center sketch
        reconstruct.py:598-619). Tables stay host numpy (jit constants)."""
        np_real = np.float32 if self.rdtype == jnp.float32 else np.float64
        self._r_cart = np.asarray(r_cart, dtype=np_real)
        self._q_cart = np.asarray(q_cart, dtype=np_real)

    def _center_density(self, rho):
        """|ρ| center of mass → reciprocal phase-ramp shift to the origin."""
        w = jnp.abs(rho) * self._w_full_weights()
        com = jnp.einsum("...c,...->c",
                         jnp.asarray(self._r_cart), w,
                         precision="highest") / jnp.sum(w)
        psi = self.ft.forward(rho)
        phase = jnp.exp(1j * jnp.einsum(
            "...c,c->...", jnp.asarray(self._q_cart), com,
            precision="highest").astype(psi.dtype))
        return self.ft.inverse(psi * phase)

    def _w_full_weights(self):
        return self._w_err  # supported-region weights suffice for the c.o.m.

    def _anchor_global_phase(self, rho):
        """Rotate out the global phase (gauge): φ = ½·arg Σ w ρ², sign chosen
        so the supported real part is net-positive."""
        z = jnp.sum(self._w_err * rho * rho)
        rho_g = rho * jnp.exp(-0.5j * jnp.angle(z)).astype(rho.dtype)
        s = jnp.sign(jnp.sum(self._w_err * rho_g.real))
        return rho_g * jnp.where(s < 0, -1.0, 1.0).astype(rho.dtype)

    def mtip_iteration(self, rho_in, support, beta, method: str, ft_stab: bool,
                       ft_gate=None):
        """One HIO/ER/RAAR step (reconstruct.py HIO sketch :576-595).
        → (rho_new, real error, reciprocal error, n̂ particle estimate —
        0 when estimation is disabled). ft_gate: optional traced 0/1 scalar
        multiplying the ft-stab correction (dynamic
        link_to_enforce_initial_support; gate 0 reproduces ft_stab=False
        exactly because the correction enters additively)."""
        if self.fix_global_phase:
            rho_in = self._anchor_global_phase(rho_in)
        if ft_stab and hasattr(self.ft, 'forward_and_roundtrip'):
            psi, roundtrip = self.ft.forward_and_roundtrip(rho_in)
        else:
            psi, roundtrip = self.ft.forward(rho_in), None
        intensity = (psi * psi.conj()).real
        analyse = getattr(self.sht, 'forward_real', self.sht.forward)
        Ilm = analyse(intensity)
        Ilm_proj = self.rc(Ilm)
        synth_real = getattr(self.sht, 'inverse_real', None)
        I_new = synth_real(Ilm_proj) if synth_real \
            else self.sht.inverse(Ilm_proj).real
        if getattr(self.rc, 'pn_enabled', False) and (
                self._pn_estimate_in is None
                or method in self._pn_estimate_in):
            n_hat, I_new = self.rc.particle_number_estimate(I_new)
        else:
            n_hat = jnp.asarray(0.0, dtype=self.rdtype)
        psi_p = project_to_modified_intensity(psi, intensity, I_new)
        rho_p = self.ft.inverse(psi_p)
        if ft_stab:
            # add back the FT-roundtrip defect of the input (except radial 0)
            rt = roundtrip if roundtrip is not None else self.ft.inverse(psi)
            corr = rho_in - rt
            if ft_gate is not None:
                corr = corr * ft_gate.astype(corr.dtype)
            rho_p = rho_p + corr.at[0].set(0)
        rho_proj, invalid = self.real(rho_p, support)
        err_real = self._real_error(rho_p, rho_proj)
        err_rec = self._reciprocal_error(psi, psi_p)
        if self._default_err_cfg:
            err, extras = err_real, ()
        else:
            # configured metric set + main combiner (reference
            # generate_main_error_routine, fxs_IO_methods.py:746-765)
            vals = {("real", "l2_projection_diff"): err_real,
                    ("reciprocal", "l2_projection_diff"): err_rec}
            if self._deg2_ref is not None:
                vals[("reciprocal", "deg2_invariant_l2_diff")] = \
                    self._deg2_error(Ilm)
            sel = ([vals[("real", n)] for n in self._main_metrics[0]]
                   + [vals[("reciprocal", n)] for n in self._main_metrics[1]])
            op = {"mean": jnp.mean, "min": jnp.min, "max": jnp.max,
                  "prod": jnp.prod}[self._main_type]
            err = op(jnp.stack(sel)) if sel else err_real
            extras = tuple([vals[("real", n)] for n in self._real_metrics]
                           + [vals[("reciprocal", n)]
                              for n in self._rec_metrics])
        if method == 'HIO':
            rho_new = hio_update(rho_in, rho_p, rho_proj, invalid, beta)
        elif method == 'RAAR':
            rho_new = raar_update(rho_in, rho_p, rho_proj, invalid, beta)
        else:
            rho_new = er_update(rho_proj)
        return rho_new, err, err_rec, n_hat, extras

    # -------------------------------------------------------------- segments
    def _run_segment(self, state: PhasingState, seg: Segment, betas=None):
        """betas may be passed as a traced array (checkpointed chunk runner)
        instead of baked in from the Segment — identical chunk structures
        then share one compilation."""
        if betas is None:
            betas = jnp.asarray(seg.betas, dtype=self.rdtype)
        gate = self._ft_gate(state, seg)


        def body(carry, beta):
            rho, best_rho, best_mask, best_err, _ = carry
            rho_new, err, err_rec, n_hat, extras = self.mtip_iteration(
                rho, state.support, beta, seg.method, seg.ft_stab,
                ft_gate=gate)
            better = err < best_err
            best_rho = jnp.where(better, rho_new, best_rho)
            best_mask = jnp.where(better, state.support, best_mask)
            best_err = jnp.minimum(err, best_err)
            cols = [err, err_rec] + ([n_hat] if self._pn_enabled else []) \
                + list(extras)
            return (rho_new, best_rho, best_mask, best_err, err), \
                jnp.stack(cols)

        carry = (state.rho, state.best_rho, state.best_mask, state.best_err,
                 state.last_err)
        carry, errs = jax.lax.scan(body, carry, betas)
        rho, best_rho, best_mask, best_err, last_err = carry
        return state._replace(
            rho=rho, best_rho=best_rho, best_mask=best_mask,
            best_err=best_err, last_err=last_err), errs

    def _shrink_wrap(self, state: PhasingState, seg: Segment, sigma=None,
                     threshold=None):
        """SW sketch (reconstruct.py:598-605) + error-gated initial-support
        enforcement (reconstruct.py:879-886)."""
        if sigma is None:
            sigma = jnp.asarray(seg.sigma, dtype=self.rdtype)
        if threshold is None:
            threshold = seg.threshold
        rho = state.rho
        if seg is not None and seg.method == 'SW_center' \
                and self._r_cart is not None:
            rho = self._center_density(rho)
        blurred = self.ft.inverse(
            self.ft.forward(jnp.abs(rho).astype(self.cdtype))
            * self.sw.gaussian_values(sigma))
        new_support = self.sw.new_support(blurred, threshold,
                                          current_support=state.support)
        enforce = state.last_err > self.enforce_limit
        support = jnp.where(enforce, new_support & self.initial_support, new_support)
        if state.enforce_hist is not None:
            # shift register, newest last (reference appends one flag per SW
            # event, reconstruct.py:879-889)
            hist = jnp.concatenate(
                [state.enforce_hist[..., 1:],
                 jnp.asarray(enforce, bool)[..., None]], axis=-1)
            return state._replace(rho=rho, support=support, enforce_hist=hist)
        return state._replace(rho=rho, support=support)

    def _snapshot(self, state: PhasingState):
        return state._replace(err_snapshot=state.best_err)

    def _reset_to_best(self, state: PhasingState):
        """RESET_TO_BEST marker: continue from the best state iff it improved
        after the SNAPSHOT point (reference reconstruct.py:945-951 — best not
        stuck in the first n sub-loop iterations). No-op without a snapshot."""
        if state.err_snapshot is None:
            return state
        late = state.best_err < state.err_snapshot
        rho = jnp.where(late, state.best_rho, state.rho)
        support = jnp.where(late, state.best_mask, state.support)
        return state._replace(rho=rho, support=support, err_snapshot=None)

    # ------------------------------------------------------------------ run
    def initial_state(self, rho0):
        """Fresh PhasingState for ONE restart (vmap outside, like run)."""
        inf = jnp.asarray(np.inf, dtype=self.rdtype)
        sup = jnp.asarray(self.initial_support)
        rho = rho0.astype(self.cdtype)
        state = PhasingState(rho=rho, support=sup, best_rho=rho,
                             best_mask=sup, best_err=inf, last_err=inf)
        return self._init_enforce_hist(state)

    def initial_state_batch(self, rho0_batch, support=None):
        """Fresh batched PhasingState (restart axis leading); jit this.
        `support` may be passed as a (traced) argument: at production scale
        the initial-support constant is ~50 MB, and embedding it re-hashes
        the program on every fresh jit wrapper."""
        n = rho0_batch.shape[0]
        if support is None:
            support = jnp.asarray(self.initial_support)
        sup = jnp.broadcast_to(support, rho0_batch.shape)
        inf = jnp.full((n,), np.inf, dtype=self.rdtype)
        rho = rho0_batch.astype(self.cdtype)
        state = PhasingState(rho=rho, support=sup, best_rho=rho,
                             best_mask=sup, best_err=inf, last_err=inf)
        return self._init_enforce_hist(state)

    def run_from(self, state: PhasingState, schedule):
        """Continue a phasing run from an existing state (checkpoint resume).
        → (state, errors (n_iter, 2))."""
        # dynamic ft_stab: make sure the enforce history exists BEFORE any
        # SW runs (direct full-schedule callers; runners register the full
        # schedule themselves so chunk sub-schedules can't shrink it)
        state = self._init_enforce_hist(state, schedule=schedule)
        err_chunks = []
        for seg in schedule:
            if seg.method in ('SW', 'SW_center'):
                state = self._shrink_wrap(state, seg)
            elif seg.method == 'SNAPSHOT':
                state = self._snapshot(state)
            elif seg.method == 'RESET_TO_BEST':
                state = self._reset_to_best(state)
            else:
                state, errs = self._run_segment(state, seg)
                err_chunks.append(errs)
        errors = jnp.concatenate(err_chunks) if err_chunks \
            else jnp.zeros((0, self._err_cols), dtype=self.rdtype)
        return state, errors

    def run_chunk(self, state: PhasingState, structure, args, tables=None):
        """Execute one schedule chunk with the ramp values passed as traced
        arrays. structure: static tuple of ('SW',) | (method, n, ft_stab);
        args: matching tuple of (sigma, threshold) | betas-array. Chunks with
        the same structure share one jit compilation. tables: optional
        arg_tables() dict threaded through the enclosing jit."""
        if tables:
            with self.bound_tables(tables):
                return self.run_chunk(state, structure, args)
        err_chunks = []
        for seg_s, a in zip(structure, args):
            if seg_s[0] in ('SW', 'SW_center'):
                state = self._shrink_wrap(
                    state, Segment(seg_s[0]),
                    sigma=jnp.asarray(a[0], dtype=self.rdtype),
                    threshold=jnp.asarray(a[1], dtype=self.rdtype))
            elif seg_s[0] == 'SNAPSHOT':
                state = self._snapshot(state)
            elif seg_s[0] == 'RESET_TO_BEST':
                state = self._reset_to_best(state)
            else:
                method, n, ft_stab = seg_s[:3]
                link_delay = seg_s[3] if len(seg_s) > 3 else 0
                seg = Segment(method, n, ft_stab=ft_stab,
                              ft_stab_link_delay=link_delay)
                state, errs = self._run_segment(
                    state, seg, betas=jnp.asarray(a, dtype=self.rdtype))
                err_chunks.append(errs)
        errors = jnp.concatenate(err_chunks) if err_chunks \
            else jnp.zeros((0, self._err_cols), dtype=self.rdtype)
        return state, errors

    def run(self, rho0, schedule):
        """Full phasing run for ONE restart; vmap over restarts outside."""
        self.register_schedule_dynamics(schedule)
        state = self.initial_state(rho0)
        # (n_iterations, 2|3): columns = (real "main" error, reciprocal
        # error[, particle-number estimate when enabled])
        return self.run_from(state, schedule)

    def finalize(self, rho):
        """Recompute the reciprocal-side quantities for an output density:
        ψ' (amplitude-projected), the last unknowns, and deg-2 invariants."""
        psi = self.ft.forward(rho.astype(self.cdtype))
        intensity = (psi * psi.conj()).real
        analyse = getattr(self.sht, 'forward_real', self.sht.forward)
        Ilm = analyse(intensity)
        W = self.rc.approximate_unknowns(Ilm)
        Ilm_proj = self.rc.project_coefficients(Ilm, W)
        synth_real = getattr(self.sht, 'inverse_real', None)
        I_new = synth_real(Ilm_proj) if synth_real \
            else self.sht.inverse(Ilm_proj).real
        psi_p = project_to_modified_intensity(psi, intensity, I_new)
        return psi_p, W

    # ------------------------------------------------------------ multi-start
    def run_batch(self, rho0_batch, schedule, tables=None):
        """vmapped multi-start phasing: rho0_batch (n_restarts, n_q, nθ, nφ).

        tables: optional arg_tables() dict passed through the ENCLOSING jit
        as an argument — required at production scale where the embedded
        tables exceed the compile-payload limit."""
        run = partial(self.run, schedule=schedule)
        with self.bound_tables(tables):
            return jax.vmap(run)(rho0_batch)


# ------------------------------------------------------------- density guess
def bump_density_guess(key, bump_envelope, grid_shape, snr, total_intensity,
                       integration_weights, cdtype=jnp.complex64):
    """Random bump-envelope initial density (reconstruct.py:1115-1175):
    ρ = (1 + U[0,1)/SNR)·bump(r), rescaled so ∫ρ² = total_intensity.
    Works for 2D (r,φ) and 3D (r,θ,φ) grids."""
    amp = 1.0 + jax.random.uniform(key, grid_shape, dtype=jnp.float32) / snr
    env = jnp.reshape(jnp.asarray(bump_envelope),
                      (-1,) + (1,) * (len(grid_shape) - 1))
    rho = amp * env
    total_sq = jnp.sum(integration_weights * rho * rho)
    rho = rho * jnp.sqrt(total_intensity / total_sq)
    return rho.astype(cdtype)
