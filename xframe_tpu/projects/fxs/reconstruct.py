"""reconstruct worker: multi-start MTIP phasing from extracted invariants.

Replaces the reference's fork-per-restart + RecipeFactory + OpenCL RPC
orchestration (reference projects/fxs/reconstruct.py, SURVEY.md §3.1) with:
one jitted phasing program (projects.fxs.phasing.MTIP) vmapped over the
restart batch and sharded over the device mesh (parallel.mesh).

Host-side responsibilities kept from the reference: invariant loading,
radial regridding of the V_l data onto the internal grid (ReGrider semantics,
reference fxs_Projections.py:639-676), Hankel-weight disk cache
(fourier_transforms.py:17-35), run archiving.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from xframe_tpu.interfaces import ProjectWorkerInterface
from xframe_tpu.library.shapes import spherical_grid, get_test_function
from xframe_tpu.ops.fourier import SphericalFourierTransform
from xframe_tpu.ops.hankel import generate_weights
from xframe_tpu.ops.integrate import SphericalIntegrator
from xframe_tpu.parallel.mesh import make_mesh, MultiStartRunner, rank_restarts
from xframe_tpu.projects.fxs import invariants as itools
from xframe_tpu.projects.fxs._database_ import ProjectDB
from xframe_tpu.projects.fxs.phasing import MTIP, build_schedule, bump_density_guess
from xframe_tpu.projects.fxs.projections import (
    ReciprocalConstraint, RealConstraint, ShrinkWrap,
)
from xframe_tpu.settings import loader as settings_loader
from xframe_tpu.settings.tools import DictNamespace
from xframe_tpu.logger import log as logger


def load_cached_weights(l_max, n_radial_points, reciprocity_coefficient,
                        dimensions, mode, allow_cache=True,
                        allow_calculation=True, allow_saving=None):
    """Hankel weight tables with the reference's disk cache keyed by
    (N, L, reciprocity coefficient, mode) (fourier_transforms.py:17-35).
    allow_calculation / allow_saving mirror the reference's
    fourier_transform.allow_weight_{calculation,saving} flags; allow_cache
    gates the load side (and is the saving default)."""
    from xframe_tpu.io import hdf5 as hdf5_io
    cache_dir = os.path.join(settings_loader.home_dir(), "cache")
    key = f"hankel_{dimensions}d_{mode}_N{n_radial_points}_L{l_max}_rc{reciprocity_coefficient:.6g}.h5"
    path = os.path.join(cache_dir, key)
    if allow_cache and os.path.exists(path):
        data = hdf5_io.load(path)
        return {"weights": np.asarray(data["weights_real"])
                + 1j * np.asarray(data["weights_imag"]),
                "posHarmOrders": np.asarray(data["posHarmOrders"]),
                "mode": mode, "dimension": dimensions}
    if not allow_calculation:
        raise FileNotFoundError(
            f"Hankel weights not cached at {path} and "
            "fourier_transform.allow_weight_calculation is False "
            "(reference fourier_transforms.py:28-32)")
    wd = generate_weights(l_max, n_radial_points, reciprocity_coefficient,
                          dimensions, mode)
    if allow_cache if allow_saving is None else allow_saving:
        os.makedirs(cache_dir, exist_ok=True)
        hdf5_io.save(path, {"weights_real": np.real(wd["weights"]),
                            "weights_imag": np.imag(wd["weights"]),
                            "posHarmOrders": wd["posHarmOrders"]})
    return wd


# Settings keys of removed features: accepted so that archived settings files
# still load, ignored, and logged (the plain jnp path is the only path).
RETIRED_KEYS = (("fourier_transform", "fused_sht"),
                ("fourier_transform", "fused_bf16_tables"),
                ("main_loop", "best_tracking"))


def _retire_settings(opt):
    """Log every retired key present in the reconstruct settings, and map
    procrustes_method 'newton_schulz_pallas' onto 'newton_schulz' (the same
    polar iteration without the removed kernel) → the keys found."""
    found = []
    for section, key in RETIRED_KEYS:
        sub = opt.get(section, {})
        if hasattr(sub, "get") and key in sub:
            found.append(f"{section}.{key}")
    ropt = opt.get("projections", {}).get("reciprocal", {})
    if str(ropt.get("procrustes_method", "")) == "newton_schulz_pallas":
        ropt["procrustes_method"] = "newton_schulz"
        found.append("projections.reciprocal.procrustes_method: "
                     "newton_schulz_pallas")
    for name in found:
        logger.info("reconstruct: retired setting %s ignored", name)
    return found


def _auto_guess_tables(ft):
    """ft.arg_tables() (host arrays — they upload as jit arguments): the
    initial-guess jits reference the Hankel tables too, and argument mode
    keeps those programs data-independent for the persistent compile cache
    (same rationale as mesh._device_tables)."""
    if not hasattr(ft, "arg_tables"):
        return {}
    return ft.arg_tables()


def _interp_radial(y, qs_data, qs_new, interpolation="linear"):
    """Interpolate (n_q_data, ...) data onto qs_new along axis 0 with the
    reference ReGrider semantics: 'nearest' | 'linear' | 'cubic', fill value
    0 outside the data range (fxs_Projections.py:639-676, gridLibrary
    ReGrider options {'fill_value': 0.0, 'interpolation': type})."""
    y = np.asarray(y)
    qs_data = np.asarray(qs_data, dtype=float)
    qs_new = np.asarray(qs_new, dtype=float)
    if y.shape[0] != len(qs_data):
        raise ValueError("radial axis mismatch")
    if len(qs_data) == len(qs_new) and np.array_equal(qs_data, qs_new):
        return y.copy()
    inside = (qs_new >= qs_data[0]) & (qs_new <= qs_data[-1])
    if interpolation == "nearest":
        idx = np.abs(qs_new[:, None] - qs_data[None, :]).argmin(axis=1)
        out = y[idx].astype(y.dtype if np.iscomplexobj(y) else float)
    elif interpolation == "cubic" and len(qs_data) >= 4:
        from scipy.interpolate import CubicSpline
        out = CubicSpline(qs_data, y, axis=0)(np.clip(
            qs_new, qs_data[0], qs_data[-1]))
    else:
        flat = y.reshape(len(qs_data), -1)
        cols = [np.interp(qs_new, qs_data, flat[:, j].real)
                + (1j * np.interp(qs_new, qs_data, flat[:, j].imag)
                   if np.iscomplexobj(y) else 0.0)
                for j in range(flat.shape[1])]
        out = np.stack(cols, axis=1).reshape((len(qs_new),) + y.shape[1:])
    out[~inside] = 0.0
    return out


def regrid_projection_matrices(proj, qs_data, qs_new, interpolation="linear"):
    """Interpolation of each V_l column from the data q-grid to the internal
    grid (reference _regrid_data, fxs_Projections.py:639-676; interpolation
    type from projections.reciprocal.regrid.interpolation)."""
    out = []
    for v in proj:
        v = np.atleast_2d(np.asarray(v))
        if v.shape[0] == 1 and v.shape[1] != len(qs_data):
            v = v.T
        out.append(_interp_radial(v.astype(complex), qs_data, qs_new,
                                  interpolation))
    return out


def pad_coeff_dense(proj_list, n_q, l_max):
    """Per-l (n_q, k≤2l+1) matrices → dense (n_q, 2L+1, L+1) coefficient
    tensor in the centered-m layout (missing columns zero-padded, as the
    reference pads before icht, reconstruct.py:404-420)."""
    L = l_max
    dense = np.zeros((n_q, 2 * L + 1, L + 1), dtype=complex)
    for l, v in enumerate(proj_list[: L + 1]):
        v = np.atleast_2d(np.asarray(v))
        if v.shape[0] != n_q:
            v = v.T
        ncols = min(v.shape[1], 2 * l + 1)
        dense[:, L - l: L - l + ncols, l] = v[:, :ncols]
    return dense


def so2_residual_rotation_phase(unknowns, proj, qs, radial_high_pass=0.2):
    """Residual in-plane rotation for 2D outputs (reference
    generate_remaining_SO_projection_2D, fxs_Projections.py:1023-1096).

    The in-loop SO(2) gauge pin leaves an m1-fold discrete rotation
    ambiguity (m1 = strongest even order); successive ranked orders reduce
    it through gcd chains. Returns the rotation angle phi0 to apply as
    coefficient rotation c_m *= exp(i*m*phi0)."""
    unknowns = np.asarray(unknowns).reshape(-1)
    M = len(unknowns) - 1
    orders = np.arange(M + 1)
    qs = np.asarray(qs, dtype=float)
    lo = int((len(qs) - 1) * float(radial_high_pass))
    strength = np.array([np.abs(np.asarray(proj[m]).reshape(-1)[lo:]).sum()
                         if m < len(proj) else 0.0 for m in orders])
    emask = (orders % 2 == 0) & (orders > 0)
    h_orders = orders[emask]
    if len(h_orders) == 0:
        return 0.0
    ranked = np.argsort(-strength[emask])  # positions into h_orders
    phases = np.angle(unknowns[emask])
    current = int(h_orders[ranked[0]])
    remaining = current
    free = np.ones(len(ranked), dtype=bool)
    rotation_phase = 0.0
    while remaining > 2:
        multiples = np.arange(current, h_orders.max() + 1, current)
        mult_idx = np.where(np.isin(h_orders, multiples))[0]
        free &= ~np.isin(ranked, mult_idx)
        if not free.any():
            break
        cur_idx = int(ranked[free][0])
        current = int(h_orders[cur_idx])
        g = int(np.gcd(remaining, current))
        n_ind = remaining // g
        if n_ind <= 1:
            continue  # order is invariant under the remaining rotations
        angle = 2 * np.pi / n_ind
        coeff = int(np.argmin((np.arange(1, n_ind) * (current // g))
                              % n_ind)) + 1
        rotation_phase -= (phases[cur_idx] // angle) * coeff * angle / g
        remaining = g
    return float(rotation_phase)


def rotate_polar_density(arr, phi0):
    """Rotate a (..., n_q, n_phi) polar-grid field in-plane by phi0 via its
    circular harmonics: c_m *= exp(i*m*phi0) (reference fix_orientation
    output modifier, reconstruct.py:736-741)."""
    arr = np.asarray(arr)
    n_phi = arr.shape[-1]
    m = np.fft.fftfreq(n_phi, d=1.0 / n_phi).round().astype(int)
    c = np.fft.fft(arr, axis=-1) * np.exp(1j * m * phi0)
    out_dtype = arr.dtype if np.iscomplexobj(arr) else np.complex128
    return np.fft.ifft(c, axis=-1).astype(out_dtype)


def _resolve_ns_schedule(ropt):
    """fxs_unknowns.ns_coefficients setting → per-step quintic coefficient
    schedule (or None for the fixed 16+4 Newton–Schulz iteration).

    'minimax' (default): the interval-optimal minimax composition from
    ops.polar_schedule — 14 steps instead of 16 quintic + 4 cubic at the
    same pinned unitarity (42 vs 56 matmul-units, a 1.33× cut of the
    Procrustes arithmetic, the largest FLOP block of the production-scale
    iteration). 'fixed': the fixed-coefficient iteration (round ≤4
    behavior)."""
    mode = str(ropt.get("ns_coefficients", "minimax"))
    if mode == "fixed":
        return None
    if mode != "minimax":
        raise ValueError(f"unknown ns_coefficients mode {mode!r} "
                         "(expected 'minimax' or 'fixed')")
    from xframe_tpu.ops.polar_schedule import default_or_computed_schedule
    return default_or_computed_schedule(
        float(ropt.get("ns_sigma_min", 1e-7)))


class ProjectWorker(ProjectWorkerInterface):
    database_class = ProjectDB

    def run(self):
        import time
        opt = self.settings
        prof = opt.get("profiling", {})
        tracing = bool(prof.get("enable", False))
        if tracing:
            # device-level trace viewable in TensorBoard/XProf (replaces the
            # reference's cProfile hooks, reconstruct.py:115-139)
            trace_dir = str(prof.get("trace_dir") or "") or os.path.join(
                settings_loader.home_dir(), "traces")
            jax.profiler.start_trace(trace_dir)
        t_setup0 = time.perf_counter()
        inv = self._load_invariants()
        mtip, ft, aux = self.setup_mtip(inv)
        schedule = self._build_schedule(ft)
        t_setup = time.perf_counter() - t_setup0
        n_restarts = int(opt.multi_start.n_reconstructions)

        seed = opt.multi_start.get("seed")
        if seed is None or seed is False:  # explicit seed 0 is a valid seed
            seed = int.from_bytes(os.urandom(4), "little")
        seed = int(seed) & 0x7FFFFFFF  # traced as int32 by initial_density_batch

        batch = int(opt.multi_start.get("batch_size", 0) or 0)
        ckpt_opt = opt.get("checkpointing", {})
        # checkpointing snapshots and runs the FULL restart batch (chunking
        # requires no checkpoint path below), so size the mesh for what
        # actually executes per program
        chunked = 0 < batch < n_restarts and not ckpt_opt.get("enable", False)
        mesh = self._make_mesh(batch if chunked else n_restarts)
        ckpt_path = None
        if ckpt_opt.get("enable", False):
            from xframe_tpu.parallel.mesh import CheckpointingRunner
            ckpt_path = os.path.join(
                settings_loader.home_dir(), "data", "fxs", "checkpoints",
                f"{opt.get('structure_name', 'default')}_phasing.h5")
            runner = CheckpointingRunner(
                mtip, schedule, mesh, checkpoint_path=ckpt_path,
                save_every=int(ckpt_opt.get("save_every", 1)))
        else:
            runner = MultiStartRunner(mtip, schedule, mesh)

        # multi_start.batch_size: run restarts in sequential chunks of this
        # size (one per-chunk fresh seed; all chunks share one compilation).
        # 0 = one program (required for checkpointing, which snapshots the
        # full batch).
        t_run0 = time.perf_counter()
        # the runner already holds the device-resident argument tables —
        # the guess jits reuse them instead of embedding the same tables as
        # program constants
        guess_tables = getattr(runner, "_tables", None) or None
        chunk_times = []           # per-chunk walls: first chunk = compile
        if batch and batch < n_restarts and ckpt_path is None:
            n_chunks = -(-n_restarts // batch)
            parts = []
            for ci in range(n_chunks):
                t_c = time.perf_counter()
                r0 = aux["initial_density_batch"](int(seed) + ci, batch,
                                                  tables=guess_tables)
                s, e = runner(r0)
                jax.block_until_ready(e)
                chunk_times.append(time.perf_counter() - t_c)
                parts.append((r0, s, e))
            cat = jax.jit(lambda *xs: jnp.concatenate(xs, axis=0))
            trim = jax.jit(lambda x: x[:n_restarts])
            rho0s = trim(cat(*[p[0] for p in parts]))
            states = jax.tree_util.tree_map(
                lambda *xs: trim(cat(*xs)), *[p[1] for p in parts])
            errors = trim(cat(*[p[2] for p in parts]))
        else:
            rho0s = aux["initial_density_batch"](int(seed), n_restarts,
                                                 tables=guess_tables)
            states, errors = runner(rho0s)
        jax.block_until_ready(errors)
        t_run = time.perf_counter() - t_run0
        order, best_err = rank_restarts(states)
        if tracing:
            jax.profiler.stop_trace()

        t_col0 = time.perf_counter()
        results = self._collect_results(mtip, ft, aux, states, errors, order,
                                        seed, rho0s=rho0s,
                                        tables=guess_tables)
        t_collect = time.perf_counter() - t_col0
        # phasing iterations only: SW/SW_center events and the
        # SNAPSHOT/RESET_TO_BEST markers (n=1 each) are not MTIP steps
        n_iter = sum(s.n for s in schedule
                     if s.method in ("HIO", "ER", "RAAR"))
        results["timing"] = {"setup_s": t_setup, "phasing_s": t_run,
                             "collect_s": t_collect,
                             "sec_per_iteration_per_restart":
                                 t_run / max(n_iter * n_restarts, 1)}
        if chunk_times:
            # chunk 0 carries the compile; the steady-state rate is the rest
            results["timing"]["chunk_walls_s"] = chunk_times
            steady = chunk_times[1:] or chunk_times
            results["timing"]["steady_sec_per_restart"] = \
                float(np.mean(steady)) / max(batch, 1)
        t_save0 = time.perf_counter()
        path, run = self.db.save("reconstructions", results)
        t_save = time.perf_counter() - t_save0
        if ckpt_path and os.path.exists(ckpt_path):
            os.remove(ckpt_path)  # completed: the archive is the durable copy
        print(f"reconstruct: {n_restarts} restarts, {n_iter} iterations each "
              f"in {t_run:.1f}s (incl. compile), best error "
              f"{best_err[order[0]]:.3e}; saved to {path}")
        print("reconstruct timing: setup {:.1f}s, phasing {:.1f}s{}, "
              "collect {:.1f}s, save {:.1f}s".format(
                  t_setup, t_run,
                  " (chunks: " + ", ".join(f"{c:.1f}" for c in chunk_times)
                  + ")" if chunk_times else "", t_collect, t_save))
        return results

    # ---------------------------------------------------------------- loading
    def _load_invariants(self):
        inp = self.settings.get("input", {})
        path = inp.get("invariants_path") or None
        run = inp.get("invariants_run") or None
        return self.db.load_invariants(run=int(run) if run else None, path=path)

    # ------------------------------------------------------------------ setup
    def setup_mtip(self, inv):
        """Build transforms + constraints from settings and invariant data.
        Returns (MTIP, ft, aux dict)."""
        dim = int(inv.get("dimensions", self.settings.get("dimensions", 3)))
        _retire_settings(self.settings)
        if dim == 2:
            return self._setup_2d(inv)
        return self._setup_3d(inv)

    def _setup_3d(self, inv):
        opt = self.settings
        real_dtype = jnp.float64 if str(opt.get("precision")) == "float64" \
            else jnp.float32
        cdtype = jnp.complex128 if real_dtype == jnp.float64 else jnp.complex64

        qs_data = np.asarray(inv["data_radial_points"], dtype=float)
        L_data = int(inv["max_order"])
        L = min(int(opt.grid.max_order), L_data)
        N = int(opt.grid.n_radial_points)
        q_max = float(opt.grid.max_q) if opt.grid.max_q else float(qs_data.max())
        mode = str(opt.fourier_transform.type)
        rc = float(opt.fourier_transform.reciprocity_coefficient)
        n_theta = int(opt.grid.n_theta) or None
        n_phi = int(opt.grid.n_phi) or None

        weights = load_cached_weights(
            L, N, rc, 3, mode,
            allow_cache=bool(opt.fourier_transform.get("allow_weight_caching",
                                                       True)),
            allow_calculation=bool(opt.fourier_transform.get(
                "allow_weight_calculation", True)),
            allow_saving=opt.fourier_transform.get("allow_weight_saving"))
        ft = SphericalFourierTransform(N, L, q_max=q_max, mode=mode,
                                       reciprocity_coefficient=rc,
                                       n_theta=n_theta, n_phi=n_phi,
                                       real_dtype=real_dtype,
                                       weights_dict=weights)
        grid = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)

        # reciprocal constraint from the data — normalized so the intensity
        # scale is O(1): raw XFEL intensities (~1e29) overflow float32 in the
        # quadratic error/procrustes sums. The reconstruction is
        # scale-equivariant; densities are rescaled by √s on save.
        ropt_regrid = str(opt.projections.reciprocal.get("regrid", {})
                          .get("interpolation", "linear"))
        proj = regrid_projection_matrices(inv["data_projection_matrices"]["I1I1"],
                                          qs_data, ft.qs,
                                          interpolation=ropt_regrid)
        avg_intensity = _interp_radial(
            np.asarray(inv["average_intensity"], dtype=float),
            qs_data, ft.qs, ropt_regrid).real
        data_scale = float(max(np.abs(avg_intensity).max(),
                               max(np.abs(v).max() for v in proj), 1e-30))
        proj = [np.asarray(v) / data_scale for v in proj]
        avg_intensity = avg_intensity / data_scale
        ropt = opt.projections.reciprocal
        used = ropt.get("used_order_ids", "all")
        if isinstance(used, str) and used == "all":
            used_ids = np.arange(L + 1)
        else:
            used_ids = np.asarray(used, dtype=int)
            used_ids = used_ids[used_ids <= L]
        radial_mask = self._radial_mask(
            ropt, L, ft.qs, qs_data=qs_data,
            q_id_limits=inv.get("data_projection_matrices_q_id_limits"))
        # particle number: static initial value ('from_data' pulls the
        # extract-side estimate from the invariants file) + optional
        # per-iteration estimation (reference reciprocal.number_of_particles
        # settings, default_0.01.yaml:132-143)
        pn_opt = ropt.number_of_particles
        n0 = pn_opt.get("initial", 1)
        if isinstance(n0, str) and n0 == "from_data":
            n0 = float(inv.get("number_of_particles", 1) or 1)
        pn_est = pn_opt.get("estimate", {})
        if isinstance(pn_est, bool):
            # reference schema: estimate is a bool + sibling 'settings'
            # subtree {project, estimate_in, scan_space}
            # (default_0.01.yaml:132-148)
            pn_est = {"apply": pn_est, **dict(pn_opt.get("settings", {}))}
        pn_apply = bool(pn_est.get("apply", False))
        pn_scan = tuple(pn_est.get("scan_space", [1.0, 10.0, 64])) \
            if pn_apply else None
        pn_project = bool(pn_est.get("project", False))
        # estimate_in: restrict the per-iteration estimation to these loop
        # methods (reference reconstruct.py:560-690; its default is ['ER']).
        # None/'all' = every method (this rebuild's historical behavior).
        pn_in = pn_est.get("estimate_in", "all")
        pn_estimate_in = None if (isinstance(pn_in, str) and pn_in == "all") \
            else tuple(str(m) for m in pn_in)
        rc_constraint = ReciprocalConstraint.build(
            proj, ft.qs, L, used_order_ids=used_ids,
            odd_orders_to_0=bool(ropt.get("odd_orders_to_0",
                ropt.get("assume_zero_odd_orders", True))),
            use_averaged_intensity=bool(ropt.get("use_averaged_intensity", True)),
            average_intensity=avg_intensity, radial_mask=radial_mask,
            n_particles=float(n0),
            schmidt_scaling=False, real_dtype=real_dtype,
            procrustes_method=str(ropt.get("procrustes_method",
                                           "newton_schulz")),
            ns_iterations=int(ropt.get("ns_iterations", 16)),
            ns_schedule=_resolve_ns_schedule(ropt),
            pn_scan_space=pn_scan, pn_project=pn_project)

        # real constraint + initial support
        popt = opt.projections.real.projections
        apply = list(popt.get("apply", ["support", "value_threshold",
                                        "limit_imag"]))
        thr = popt.get("value_threshold", {}).get("threshold", [0, False])
        # absolute thresholds are given in PHYSICAL density units; the
        # internal state is normalized by √data_scale (I ∝ s ⇒ ρ ∝ √s)
        unit = 1.0 / np.sqrt(data_scale)
        real_constraint = RealConstraint(
            apply_support="support" in apply,
            apply_value_threshold="value_threshold" in apply,
            threshold_low=None if thr[0] is False else float(thr[0]) * unit,
            threshold_high=float(thr[1]) * unit
            if (len(thr) > 1 and thr[1]) else None,
            apply_limit_imag="limit_imag" in apply,
            limit_imag=float(popt.get("limit_imag", {}).get("threshold", 2.0))
            * unit,
            apply_assert_real="assert_real" in apply,
            considered_projections=tuple(
                opt.projections.real.get("HIO", {})
                .get("considered_projections", ["all"]) or ["all"]))
        is_opt = popt.get("support", {}).get("initial_support", {})
        if str(is_opt.get("type", "max_radius")) == "auto_correlation":
            # support from the data's autocorrelation-like synthesis
            # A = iFT(iSHT(V_padded)): keep A ≥ threshold·max(A), clipped to
            # the particle radius (reference fxs_Projections.py:141-146 with
            # the autocorrelation built at reconstruct.py:400-425)
            thr = float(is_opt.get("auto_correlation", {})
                        .get("threshold", 0.01))
            dense = pad_coeff_dense(proj, N, L)
            np_r = np.float32 if real_dtype == jnp.float32 else np.float64
            # production-sized FT tables enter as jit ARGUMENTS (as in the
            # runners / _lowres_env below)
            ft_tables = _auto_guess_tables(ft)

            @jax.jit
            def _autocorr(tables, c_re, c_im):
                with ft.bound_tables(tables):
                    a = ft.inverse(ft.sht.inverse(
                        (c_re + 1j * c_im).astype(cdtype)))
                    return a.real.astype(real_dtype)

            A = np.asarray(_autocorr(
                ft_tables,
                np.ascontiguousarray(dense.real, dtype=np_r),
                np.ascontiguousarray(dense.imag, dtype=np_r)))
            initial_support = (A >= thr * A.max()) \
                & (np.asarray(grid[..., 0]) <= float(opt.particle_radius))
        else:
            support_radius = float(is_opt.get("max_radius",
                                              opt.particle_radius))
            initial_support = grid[..., 0] < support_radius
        enforce_opt = popt.get("support", {}).get("enforce_initial_support", {})
        enforce_limit = float(enforce_opt.get("if_error_bigger_than", np.inf)) \
            if enforce_opt.get("apply", False) else np.inf

        integ = SphericalIntegrator(ft.rs, ft.sht.n_theta, ft.sht.n_phi,
                                    real_dtype=real_dtype)
        # separable weights: MTIP masks by the support in-trace (keeps the
        # grid-sized product out of the compiled payload at production scale)
        w_err = integ.w_broadcast
        swopt = opt.projections.real.shrink_wrap
        sw = ShrinkWrap.build(
            ft.qs, real_dtype=real_dtype,
            mode=str(swopt.get("mode", "threshold")),
            volume_fraction=float(swopt.get("fixed_volume", {})
                                  .get("volume", 0.5)),
            integration_weights=np.asarray(integ._w),
            initial_support=initial_support,
            fixed_volume_method=str(swopt.get("fixed_volume", {})
                                    .get("method", "sort")),
            max_volume_change=swopt.get("fixed_volume", {})
                              .get("max_volume_change", 0.2))
        mtip = MTIP(ft, rc_constraint, real_constraint, sw, w_err,
                    initial_support,
                    enforce_initial_support_limit=enforce_limit,
                    real_dtype=real_dtype, pn_estimate_in=pn_estimate_in,
                    error_config=self._error_config(opt))
        # SW_center support: cartesian grid tables for the c.o.m. shift
        from xframe_tpu.library.shapes import spherical_to_cartesian
        grid_q = spherical_grid(ft.qs, ft.sht.theta, ft.sht.phi)
        mtip.enable_centering(spherical_to_cartesian(grid),
                              spherical_to_cartesian(grid_q))

        # initial-density machinery (reference reconstruct.py:1115-1210)
        total_intensity = float(np.trapezoid(avg_intensity * ft.qs ** 2, ft.qs)
                                * 2 * np.sqrt(np.pi))
        gopt = opt.density_guess
        gtype = str(gopt.get("type", "bump"))
        radius = float(gopt.get("radius", opt.particle_radius))
        if gtype == "ball":
            bump = (ft.rs < radius).astype(float)
        elif gtype == "low_resolution_autocorrelation":
            # reference uses a fixed gentle slope here (reconstruct.py:1196)
            bump = get_test_function(support=[-radius, radius],
                                     slope=float(gopt.get("bump", {})
                                                 .get("slope", 0.1)))(ft.rs)
        else:
            slope = float(gopt.get("bump", {}).get("slope", 0.3))
            bump = get_test_function(support=[-radius, radius],
                                     slope=slope)(ft.rs)
        snr = float(gopt.get("random", {}).get("SNR", 2.0))
        if str(gopt.get("amplitude_function", "random")) != "random":
            snr = float("inf")  # uniform amplitude: deterministic envelope
        np_real = np.float32 if real_dtype == jnp.float32 else np.float64
        bump_host = np.asarray(bump, dtype=np_real)
        w_full = np.asarray(integ.w_broadcast)
        shape = (N, ft.sht.n_theta, ft.sht.n_phi)
        from functools import partial

        if gtype == "low_resolution_autocorrelation":
            # ρ₀ ∝ clip(iFT(iSHT(V_low)), 0) · (1 + U/SNR) · bump(r),
            # rescaled to the total intensity (reference
            # reconstruct.py:1175-1205): the low-order projection matrices
            # synthesize a low-resolution autocorrelation-like envelope.
            lr = inv.get("data_low_resolution_intensity_coefficients")
            if lr is None:
                raise KeyError(
                    "density_guess.type=low_resolution_autocorrelation needs "
                    "'data_low_resolution_intensity_coefficients' in the "
                    "invariants file, but it is absent — re-run the extract "
                    "worker (it writes the key) or pick another guess type")
            if isinstance(lr, dict):  # per-l matrices (extract lr_max > 0)
                lr_list = [np.atleast_2d(np.asarray(lr[k]))
                           for k in sorted(lr, key=int)]
            else:  # isotropic-only vector I_00 = a(q)·2√π
                lr_list = [np.asarray(lr, dtype=complex)[:, None]]
            lr_list = regrid_projection_matrices(
                lr_list, qs_data, ft.qs,
                interpolation=str(opt.projections.reciprocal
                                  .get("regrid", {})
                                  .get("interpolation", "linear")))
            Ilm = pad_coeff_dense(lr_list, N, L) / data_scale

            # the FT tables referenced by the guess enter every jit below as
            # ARGUMENTS, as in the runners
            ft_tables = _auto_guess_tables(ft)

            @jax.jit
            def _lowres_env(tables, c_re, c_im):
                with ft.bound_tables(tables):
                    a = ft.inverse(ft.sht.inverse(
                        (c_re + 1j * c_im).astype(cdtype)))
                    return jnp.clip(a.real, 0.0, None).astype(real_dtype)

            env_full = np.asarray(
                _lowres_env(
                    ft_tables,
                    np.ascontiguousarray(Ilm.real, dtype=np_real),
                    np.ascontiguousarray(Ilm.imag, dtype=np_real)),
                dtype=np_real) * bump_host[:, None, None]
            # envelope enters as a traced ARGUMENT (a grid-sized closed-over
            # constant would bloat the program at production scale)
            env_dev = jax.device_put(env_full)

            def _guess_env(env, k):
                amp = 1.0 + jax.random.uniform(k, shape,
                                               dtype=real_dtype) / snr
                rho = (env * amp).astype(real_dtype)
                tot = jnp.sum(w_full * rho * rho)
                rho = (rho * jnp.sqrt(total_intensity / tot)).astype(cdtype)
                return ft.inverse(ft.forward(rho))

            @partial(jax.jit, static_argnums=(3,))
            def _batch_env(tables, env, seed, n):
                with ft.bound_tables(tables):
                    keys = jax.random.split(jax.random.PRNGKey(seed), n)
                    return jax.vmap(partial(_guess_env, env))(keys)

            def initial_density_batch(seed, n, tables=None):
                return _batch_env(tables if tables else ft_tables,
                                  env_dev, seed, n)
        else:
            ft_tables = _auto_guess_tables(ft)

            def _guess(k):
                rho0 = bump_density_guess(k, bump_host, shape, snr=snr,
                                          total_intensity=total_intensity,
                                          integration_weights=w_full,
                                          cdtype=cdtype)
                return ft.inverse(ft.forward(rho0))

            @partial(jax.jit, static_argnums=(2,))
            def _batch(tables, seed, n):
                # seed is TRACED (int32): new seeds reuse one compilation —
                # chunked restarts would otherwise recompile per chunk
                with ft.bound_tables(tables):
                    return jax.vmap(_guess)(
                        jax.random.split(jax.random.PRNGKey(seed), n))

            def initial_density_batch(seed, n, tables=None):
                return _batch(tables if tables else ft_tables, seed, n)

        aux = dict(grid=grid, initial_support=initial_support,
                   initial_density_batch=initial_density_batch,
                   avg_intensity=avg_intensity, wavelength=inv["xray_wavelength"],
                   proj=proj, rc=rc, total_intensity=total_intensity,
                   dimensions=3, data_scale=data_scale)
        return mtip, ft, aux

    def _setup_2d(self, inv):
        """Polar (2D) MTIP setup: circular-harmonic data projection with
        rank-1 V_m vectors (reference dim-2 branches of fxs_Projections.py)."""
        from xframe_tpu.library.shapes import polar_grid
        from xframe_tpu.ops.fourier import PolarFourierTransform
        from xframe_tpu.ops.integrate import PolarIntegrator
        from xframe_tpu.projects.fxs.projections import (
            ReciprocalConstraintPolar, RealCircularHarmonics)
        opt = self.settings
        real_dtype = jnp.float64 if str(opt.get("precision")) == "float64" \
            else jnp.float32
        cdtype = jnp.complex128 if real_dtype == jnp.float64 else jnp.complex64

        qs_data = np.asarray(inv["data_radial_points"], dtype=float)
        M = min(int(opt.grid.max_order), int(inv["max_order"]))
        N = int(opt.grid.n_radial_points)
        q_max = float(opt.grid.max_q) if opt.grid.max_q else float(qs_data.max())
        ft_mode = str(opt.fourier_transform.type)
        rc_coef = float(opt.fourier_transform.reciprocity_coefficient)
        n_phi = int(opt.grid.get("n_phi") or 0)
        if n_phi <= 0:
            n_phi = 2 ** int(np.ceil(np.log2(2 * (M + 1))))

        weights = load_cached_weights(
            M, N, rc_coef, 2, ft_mode,
            allow_cache=bool(opt.fourier_transform.get("allow_weight_caching",
                                                       True)),
            allow_calculation=bool(opt.fourier_transform.get(
                "allow_weight_calculation", True)),
            allow_saving=opt.fourier_transform.get("allow_weight_saving"))
        ft = PolarFourierTransform(N, M, n_phi, q_max, mode=ft_mode,
                                   reciprocity_coefficient=rc_coef,
                                   real_dtype=real_dtype, weights_dict=weights)
        phis = 2 * np.pi * np.arange(n_phi) / n_phi
        grid = polar_grid(ft.rs, phis)

        ropt_regrid = str(opt.projections.reciprocal.get("regrid", {})
                          .get("interpolation", "linear"))
        proj = regrid_projection_matrices(
            inv["data_projection_matrices"]["I1I1"], qs_data, ft.qs,
            interpolation=ropt_regrid)
        proj = [np.asarray(v).reshape(len(ft.qs), -1)[:, 0] for v in proj]
        avg_intensity = _interp_radial(
            np.asarray(inv["average_intensity"], dtype=float),
            qs_data, ft.qs, ropt_regrid).real
        # float32 overflow guard: normalize the data scale (see _setup_3d)
        data_scale = float(max(np.abs(avg_intensity).max(),
                               max(np.abs(v).max() for v in proj), 1e-30))
        proj = [np.asarray(v) / data_scale for v in proj]
        avg_intensity = avg_intensity / data_scale
        ropt = opt.projections.reciprocal
        used = ropt.get("used_order_ids", "all")
        if isinstance(used, str) and used == "all":
            used_ids = np.arange(M + 1)
        else:
            used_ids = np.asarray(used, dtype=int)
            used_ids = used_ids[used_ids <= M]
        so_pin = None
        so_opt = ropt.get("SO_freedom", {})
        if bool(so_opt.get("use", so_opt.get("apply", False))):
            # pin the strongest even nonzero order (reference SO(2) fix)
            hp = float(so_opt.get("radial_high_pass", 0.2))
            lo = int((len(ft.qs) - 1) * hp)
            scores = [np.abs(np.asarray(v)[lo:]).sum() if (m % 2 == 0 and m > 0)
                      else -1.0 for m, v in enumerate(proj)]
            so_pin = int(np.argmax(scores))
        rc_constraint = ReciprocalConstraintPolar.build(
            proj, ft.qs, M, used_order_ids=used_ids, so_pin_order=so_pin,
            odd_orders_to_0=bool(ropt.get("odd_orders_to_0",
                ropt.get("assume_zero_odd_orders", True))),
            use_averaged_intensity=bool(ropt.get("use_averaged_intensity", True)),
            average_intensity=avg_intensity,
            radial_mask=self._radial_mask(
                ropt, M, ft.qs, qs_data=qs_data,
                q_id_limits=inv.get("data_projection_matrices_q_id_limits")),
            n_particles=float(ropt.number_of_particles.get("initial", 1)),
            real_dtype=real_dtype)

        popt = opt.projections.real.projections
        apply = list(popt.get("apply", ["support", "value_threshold",
                                        "limit_imag"]))
        thr = popt.get("value_threshold", {}).get("threshold", [0, False])
        # absolute thresholds are given in PHYSICAL density units; the
        # internal state is normalized by √data_scale (I ∝ s ⇒ ρ ∝ √s)
        unit = 1.0 / np.sqrt(data_scale)
        real_constraint = RealConstraint(
            apply_support="support" in apply,
            apply_value_threshold="value_threshold" in apply,
            threshold_low=None if thr[0] is False else float(thr[0]) * unit,
            threshold_high=float(thr[1]) * unit
            if (len(thr) > 1 and thr[1]) else None,
            apply_limit_imag="limit_imag" in apply,
            limit_imag=float(popt.get("limit_imag", {}).get("threshold", 2.0))
            * unit,
            apply_assert_real="assert_real" in apply,
            considered_projections=tuple(
                opt.projections.real.get("HIO", {})
                .get("considered_projections", ["all"]) or ["all"]))
        support_radius = float(popt.get("support", {}).get(
            "initial_support", {}).get("max_radius", opt.particle_radius))
        initial_support = grid[..., 0] < support_radius
        enforce_opt = popt.get("support", {}).get("enforce_initial_support", {})
        enforce_limit = float(enforce_opt.get("if_error_bigger_than", np.inf)) \
            if enforce_opt.get("apply", False) else np.inf

        integ = PolarIntegrator(ft.rs, n_phi, real_dtype=real_dtype)
        w_err = np.asarray(integ._w) * initial_support
        swopt = opt.projections.real.shrink_wrap
        sw = ShrinkWrap.build(
            ft.qs, grid_rank=2, real_dtype=real_dtype,
            mode=str(swopt.get("mode", "threshold")),
            volume_fraction=float(swopt.get("fixed_volume", {})
                                  .get("volume", 0.5)),
            integration_weights=np.asarray(integ._w),
            initial_support=initial_support,
            fixed_volume_method=str(swopt.get("fixed_volume", {})
                                    .get("method", "sort")),
            max_volume_change=swopt.get("fixed_volume", {})
                              .get("max_volume_change", 0.2))
        cht = RealCircularHarmonics(n_phi, M)
        mtip = MTIP(ft, rc_constraint, real_constraint, sw, w_err,
                    initial_support,
                    enforce_initial_support_limit=enforce_limit,
                    real_dtype=real_dtype, harmonic=cht,
                    error_config=self._error_config(opt))
        # cartesian grid tables for SW_center and the shift_to_center output
        # modifier (the reference's shift operators work in both dims,
        # fxs_Projections.py:1419-1444); without these the 2D modifier would
        # silently no-op
        from xframe_tpu.library.shapes import polar_grid

        def _polar_cart(grid):
            return np.stack((grid[..., 0] * np.cos(grid[..., 1]),
                             grid[..., 0] * np.sin(grid[..., 1])), axis=-1)

        phis = 2 * np.pi * np.arange(n_phi) / n_phi
        mtip.enable_centering(_polar_cart(polar_grid(ft.rs, phis)),
                              _polar_cart(polar_grid(ft.qs, phis)))

        total_intensity = float(np.trapezoid(avg_intensity * ft.qs, ft.qs)
                                * 2 * np.pi)
        gopt = opt.density_guess
        radius = float(gopt.get("radius", opt.particle_radius))
        if str(gopt.get("type", "bump")) == "ball":
            bump = (ft.rs < radius).astype(float)
        else:
            slope = float(gopt.get("bump", {}).get("slope", 0.3))
            bump = get_test_function(support=[-radius, radius],
                                     slope=slope)(ft.rs)
        snr = float(gopt.get("random", {}).get("SNR", 2.0))
        if str(gopt.get("amplitude_function", "random")) != "random":
            snr = float("inf")  # uniform amplitude: deterministic envelope
        np_real = np.float32 if real_dtype == jnp.float32 else np.float64
        bump_host = np.asarray(bump, dtype=np_real)
        w_full = np.asarray(integ._w)
        shape = (N, n_phi)

        def _guess(k):
            rho0 = bump_density_guess(k, bump_host, shape, snr=snr,
                                      total_intensity=total_intensity,
                                      integration_weights=w_full, cdtype=cdtype)
            return ft.inverse(ft.forward(rho0))

        from functools import partial

        @partial(jax.jit, static_argnums=(1,))
        def _batch2d(seed, n):
            # seed is TRACED (int32): new seeds reuse one compilation — chunked
            # restarts would otherwise recompile per chunk
            return jax.vmap(_guess)(jax.random.split(jax.random.PRNGKey(seed), n))

        def initial_density_batch(seed, n, tables=None):
            # 2D tables are tiny; the kwarg only keeps the worker call
            # signature uniform across dimensions
            return _batch2d(seed, n)

        aux = dict(grid=grid, initial_support=initial_support,
                   initial_density_batch=initial_density_batch,
                   avg_intensity=avg_intensity,
                   wavelength=inv["xray_wavelength"],
                   proj=proj, rc=rc_coef, total_intensity=total_intensity,
                   dimensions=2, phis=phis, data_scale=data_scale,
                   so_pin=so_pin,
                   so_radial_high_pass=float(so_opt.get("radial_high_pass",
                                                        0.2)))
        return mtip, ft, aux

    def _error_config(self, opt):
        """main_loop.error.methods → MTIP error_config (reference
        reconstruct.py:796-799 + fxs_IO_methods.py:287-401,746-765)."""
        eopt = opt.main_loop.get("error", {})
        methods = eopt.get("methods", {})
        real = methods.get("real", {})
        rec = methods.get("reciprocal", {})
        main = methods.get("main", {})
        cfg = {
            "real": list(real.get("calculate", ["l2_projection_diff"])),
            "reciprocal": list(rec.get("calculate", [])),
            "real_inside_initial_support": bool(
                real.get("l2_projection_diff", {})
                .get("inside_initial_support", True)),
            "deg2_order": int(rec.get("deg2_invariant_l2_diff", {})
                              .get("order", 2)),
        }
        if main:
            mm = main.get("metrics", {})
            cfg["main"] = {
                "metrics": {
                    "real": list(mm.get("real", ["l2_projection_diff"])),
                    "reciprocal": list(mm.get("reciprocal", []))},
                "type": str(main.get("type", "mean"))}
        return cfg

    def _radial_mask(self, ropt, L, qs, qs_data=None, q_id_limits=None):
        """Reciprocal-projection radial mask of shape (L+1, n_q).

        Reference ReciprocalProjection.generate_radial_mask
        (fxs_Projections.py:578-630): type 'none' | 'manual' (region or
        order_dependent_line) | 'from_projection_matrices' (per-order data
        q-id limits); every variant is intersected with the data q-range
        (fxs_Projections.py:585-586,629)."""
        qm = ropt.get("q_mask", {})
        mtype = str(qm.get("type", "none"))
        qs = np.asarray(qs, dtype=float)
        mask = np.ones((L + 1, len(qs)), dtype=bool)
        if mtype in ("from_projection_matrices", "from_invariants"):
            if q_id_limits is None or qs_data is None:
                logger.warning("q_mask type %r needs data q-id limits; "
                               "proceeding without custom q_mask", mtype)
            else:
                lims = np.asarray(q_id_limits, dtype=int).reshape(-1, 2)
                qs_data = np.asarray(qs_data, dtype=float)
                for l in range(min(L + 1, len(lims))):
                    lo_id, hi_id = lims[l]
                    if hi_id <= lo_id:
                        mask[l] = False
                        continue
                    mask[l] = ((qs > qs_data[lo_id])
                               & (qs < qs_data[hi_id - 1]))
        elif mtype == "manual":
            man = qm.get("manual", None)
            if isinstance(man, (dict, DictNamespace)):
                sub = str(man.get("type", "region"))
            else:
                man = qm  # legacy flat schema: region directly under q_mask
                sub = "region"
            if sub == "region":
                lo, hi = man.get("region", [False, False])
                if lo is not False and lo is not None:
                    mask &= (qs >= float(lo))[None, :]
                if hi is not False and hi is not None:
                    mask &= (qs < float(hi))[None, :]
            elif sub == "order_dependent_line":
                pts = np.asarray(man.get("order_dependent_line",
                                         [[4, 0.004], [70, 0.3]]), dtype=float)
                # keep the (order, q) half-plane where the signed distance
                # from the line p1→p2 is <= 0 (mathLibrary.py:1131-1137:
                # rot = [[0,1],[-1,0]] @ (p2-p1); keep -dist >= 0)
                p1, p2 = pts
                d = p2 - p1
                rot = np.array([d[1], -d[0]])
                ls = np.arange(L + 1, dtype=float)
                dist = ((ls[:, None] - p1[0]) * rot[0]
                        + (qs[None, :] - p1[1]) * rot[1])
                mask = (-dist) >= 0
            else:
                logger.warning("Unknown manual q_mask type %r; proceeding "
                               "without custom q_mask", sub)
        elif mtype != "none":
            logger.warning("Could not parse projections.reciprocal.q_mask "
                           "type %r. Proceeding without custom q_mask", mtype)
        if qs_data is not None and len(qs_data):
            qs_data = np.asarray(qs_data, dtype=float)
            mask &= ((qs >= qs_data.min()) & (qs <= qs_data.max()))[None, :]
        if mask.all():
            return None
        return mask

    def _build_schedule(self, ft):
        opt = self.settings
        main_loop = opt.main_loop.sub_loops
        hio_betas = opt.projections.real.HIO.beta
        sw_sigmas = opt.projections.real.shrink_wrap.sigmas
        sw_thresholds = opt.projections.real.shrink_wrap.thresholds
        ft_stab = opt.main_loop.get("ft_stabilization", {})
        dr = float(ft.rs[1] - ft.rs[0])
        return build_schedule(main_loop, hio_betas, sw_sigmas, sw_thresholds,
                              ft_stab, default_sigma=dr)

    def _make_mesh(self, n_restarts):
        opt = self.settings.get("mesh", {})
        devices = jax.devices()
        if len(devices) <= 1:
            return None
        r = opt.get("restarts", "all")
        t = int(opt.get("theta", 1))
        n_r = len(devices) // t if (isinstance(r, str) and r == "all") else int(r)
        n_r = max(1, min(n_r, n_restarts, len(devices) // t))
        axes = {"restarts": n_r}
        if t > 1:
            axes["theta"] = t
        return make_mesh(axes)

    # ------------------------------------------------------------ result save
    def _collect_results(self, mtip, ft, aux, states, errors, order, seed,
                         rho0s=None, tables=None):
        opt = self.settings
        keep = opt.multi_start.get("results_to_keep", "all")
        ids = order if (isinstance(keep, str) and keep == "all") \
            else order[: int(keep)]
        errors_h = np.asarray(errors)

        # undo the setup-time data normalization: I ∝ s ⇒ ψ, ρ ∝ √s
        sqrt_s = float(np.sqrt(aux.get("data_scale", 1.0)))
        # output_density_modifiers.shift_to_center: center-of-mass shift via
        # reciprocal phase ramps on every saved density (reference
        # assemble_output_modifier, reconstruct.py:453-463,494)
        center_out = bool(opt.get("output_density_modifiers", {})
                          .get("shift_to_center", False)) \
            and getattr(mtip, "_r_cart", None) is not None
        # output_density_modifiers.fix_orientation (2D, reference
        # reconstruct.py:736-751): resolve the residual discrete in-plane
        # rotation ambiguity left by the SO(2) gauge pin via the final
        # per-order unknowns. Requires the in-loop SO freedom to be active.
        fix_orient = bool(opt.get("output_density_modifiers", {})
                          .get("fix_orientation", False)) \
            and aux.get("dimensions", 3) == 2
        if fix_orient and aux.get("so_pin") is None:
            logger.warning(
                "fix_orientation requested but SO_freedom is not used in the "
                "reciprocal projection - skipping orientation fixing "
                "(reference reconstruct.py:748-751)")
            fix_orient = False

        results = {}
        init_sup_h = np.asarray(aux["initial_support"])
        best_err_h = np.atleast_1d(np.asarray(states.best_err))

        # one device→host transfer per array KIND, stacked over the kept
        # restarts, instead of several per restart
        idx = jnp.asarray(np.asarray(ids, dtype=np.int32))
        take = jax.jit(lambda a, i: jnp.take(a, i, axis=0))

        rho_b = take(states.best_rho, idx)
        last_b = take(states.rho, idx)
        if center_out:
            cfn = jax.jit(jax.vmap(mtip._center_density))
            rho_b = cfn(rho_b)
            last_b = cfn(last_b)

        # bind the runner's argument tables (if any) so the finalize program
        # is data-independent — embedded V/PD constants change with every
        # extract output and defeat the persistent compile cache across runs
        def _finalize(t, r):
            with mtip.bound_tables(t):
                return jax.vmap(mtip.finalize)(r)

        psi_b, W_b = jax.jit(_finalize)(tables or {}, rho_b)
        rho_bh, last_bh, psi_bh, W_bh, bm_bh, sm_bh = jax.device_get(
            (rho_b, last_b, psi_b, W_b, take(states.best_mask, idx),
             take(states.support, idx)))
        init_bh = np.asarray(take(rho0s, idx)) if rho0s is not None \
            else None

        for rank, i in enumerate(ids):
            i = int(i)
            rho_h = rho_bh[rank]
            last_h = last_bh[rank]
            psi_h = psi_bh[rank]
            W = W_bh[rank]
            if fix_orient:
                phi0 = so2_residual_rotation_phase(
                    W, aux["proj"], ft.qs,
                    aux.get("so_radial_high_pass", 0.2))
                if phi0:
                    rho_h = rotate_polar_density(rho_h, phi0)
                    last_h = rotate_polar_density(last_h, phi0)
                    psi_h = rotate_polar_density(psi_h, phi0)
            results[str(rank)] = {
                "real_density": rho_h * sqrt_s,
                "last_real_density": last_h * sqrt_s,
                "reciprocal_density": psi_h * sqrt_s,
                "support_mask": bm_bh[rank],
                "last_support_mask": sm_bh[rank],
                "initial_density": init_bh[rank] * sqrt_s
                if init_bh is not None else None,
                "initial_support": init_sup_h,
                "fxs_unknowns": W,
                "error_dict": {"main": errors_h[i][:, 0],
                               "reciprocal": errors_h[i][:, 1],
                               "final": float(best_err_h[i]),
                               # configured per-metric curves (main_loop
                               # .error.methods, reference error_dict layout)
                               **{nm: errors_h[i][:, j]
                                  for j, nm in enumerate(
                                      getattr(mtip, "error_names",
                                              ["main", "reciprocal"]))
                                  if j >= 2 + int(getattr(
                                      mtip, "_pn_enabled", False))}},
                "n_particles": float(mtip.rc.n_particles),
            }
            if errors_h[i].shape[-1] > 2:
                # per-iteration particle-number estimates (reference records
                # n_particles history per save_number_of_particles op)
                hist = errors_h[i][:, 2]
                results[str(rank)]["n_particles_history"] = hist
                results[str(rank)]["n_particles"] = float(hist[-1]) \
                    if len(hist) else float(mtip.rc.n_particles)
        # fidelity diagnostic for the best restart: relative diff between the
        # reconstruction's deg-2 invariants and the data's B_l = V_l V_l†
        # (reference deg2-invariant error metric, fxs_IO_methods.py:312-...)
        if results and aux.get("dimensions", 3) == 2:
            best = results["0"]
            rho_n = best["real_density"] / max(sqrt_s, 1e-30)
            coeff = np.asarray(jax.jit(
                lambda r: mtip.sht.forward((lambda p: (
                    p * p.conj()).real)(ft.forward(r))))(
                jnp.asarray(rho_n, dtype=mtip.cdtype)))
            bm_rec = itools.harmonic_coeff_to_deg2_invariants_2d(coeff)
            diffs = []
            for m in range(0, bm_rec.shape[0], 2):
                v = np.asarray(aux["proj"][m]).reshape(-1)
                bm_data = np.outer(v, v.conj())
                scale = np.abs(bm_data).max()
                if scale > 0:
                    diffs.append(np.abs(np.abs(bm_rec[m]) - np.abs(bm_data)
                                        ).mean() / scale)
            best["error_dict"]["deg2_invariant_relative"] =                 np.asarray(diffs, dtype=np.float32)
        if results and aux.get("dimensions", 3) == 3:
            best = results["0"]
            rho_n = best["real_density"] / max(sqrt_s, 1e-30)  # normalized units
            coeff = np.asarray(jax.jit(
                lambda r: mtip.sht.forward_real((lambda p: (
                    p * p.conj()).real)(ft.forward(r))))(
                jnp.asarray(rho_n, dtype=mtip.cdtype)))
            bl_rec = itools.harmonic_coeff_to_deg2_invariants_3d(coeff)
            bl_data = itools.projection_matrices_to_deg2_invariant_3d(
                aux["proj"])
            diffs = []
            for l in range(0, min(len(bl_data), bl_rec.shape[0]), 2):
                scale = np.abs(bl_data[l]).max()
                if scale > 0:
                    diffs.append(np.abs(bl_rec[l] - bl_data[l]).mean() / scale)
            best["error_dict"]["deg2_invariant_relative"] = \
                np.asarray(diffs, dtype=np.float32)
        if aux.get("dimensions", 3) == 3:
            grid_cfg = {
                "real_grid": np.asarray(ft.rs),
                "reciprocal_grid": np.asarray(ft.qs),
                "thetas": np.asarray(ft.sht.theta),
                "phis": np.asarray(ft.sht.phi),
            }
            max_order = ft.sht.l_max
        else:
            grid_cfg = {
                "real_grid": np.asarray(ft.rs),
                "reciprocal_grid": np.asarray(ft.qs),
                "phis": np.asarray(aux["phis"]),
            }
            max_order = ft.m_max
        return {
            "configuration": {
                "internal_grid": grid_cfg,
                "dimensions": aux.get("dimensions", 3),
                "reciprocity_coefficient": aux["rc"],
                "xray_wavelength": float(aux["wavelength"]),
                "max_order": max_order,
                "fourier_transform_mode": ft.mode,
                "q_max": float(ft.q_max),
                "seed": int(seed),
            },
            "projection_matrices": [np.asarray(v)
                                    * aux.get("data_scale", 1.0)
                                    for v in aux["proj"]],
            "average_intensity": np.asarray(aux["avg_intensity"])
            * aux.get("data_scale", 1.0),
            "reconstruction_results": results,
        }
