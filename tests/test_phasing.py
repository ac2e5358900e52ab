"""End-to-end MTIP phasing tests on a small synthetic problem.

Parity target (SURVEY.md §7.4): from the invariants of a known density, the
jitted phasing loop must drive the projection error down and reproduce the
rotation-invariant B_l fingerprint of the input.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from xframe_tpu.ops.fourier import SphericalFourierTransform
from xframe_tpu.ops.integrate import SphericalIntegrator
from xframe_tpu.library.shapes import spherical_grid, ball_density, get_test_function
from xframe_tpu.projects.fxs import invariants as itools
from xframe_tpu.projects.fxs.projections import (ReciprocalConstraint,
                                                 RealConstraint, ShrinkWrap)
from xframe_tpu.projects.fxs.phasing import (MTIP, Segment, bump_density_guess,
                                             build_schedule)


@pytest.fixture(scope="module")
def problem():
    N, L = 32, 16
    q_max = 0.4
    wavelength = 1.23984
    ft = SphericalFourierTransform(N, L, q_max=q_max, mode="midpoint",
                                   reciprocity_coefficient=2.0,
                                   real_dtype=jnp.float32)
    grid = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)
    radius = ft.r_max / 2.2
    rho = ball_density(grid, radius / 2.5, center=(radius / 2, 1.2, 0.7)) \
        + 0.7 * ball_density(grid, radius / 3.0, center=(radius / 2.2, 2.1, 3.9))
    psi = ft.forward(jnp.asarray(rho, dtype=jnp.complex64))
    intensity = np.asarray((psi * psi.conj()).real)
    coeff = np.asarray(ft.sht.forward(jnp.asarray(intensity)))
    bl = itools.harmonic_coeff_to_deg2_invariants_3d(coeff).real.astype(complex)
    bl[1::2] = 0  # Friedel
    proj, eigs = itools.deg2_invariant_to_projection_matrices(bl)
    avg_intensity = np.sqrt(np.diag(bl[0]).real / (4 * np.pi))
    integ = SphericalIntegrator(ft.rs, ft.sht.n_theta, ft.sht.n_phi,
                                real_dtype=jnp.float32)
    total_intensity = float(np.trapezoid(avg_intensity * ft.qs ** 2, ft.qs)
                            * 2 * np.sqrt(np.pi))
    initial_support = grid[..., 0] < radius * 1.2
    rc = ReciprocalConstraint.build(proj, ft.qs, L,
                                    use_averaged_intensity=True,
                                    average_intensity=avg_intensity,
                                    odd_orders_to_0=True,
                                    schmidt_scaling=False)
    real = RealConstraint(limit_imag=2.0)
    sw = ShrinkWrap.build(ft.qs)
    w = np.asarray(integ._w) * initial_support
    mtip = MTIP(ft, rc, real, sw, w, initial_support,
                enforce_initial_support_limit=6e-3)
    return dict(ft=ft, mtip=mtip, bl=bl, rho_true=rho, radius=radius,
                total_intensity=total_intensity, integ=integ, grid=grid, N=N, L=L)


def _initial_density(problem, key):
    ft = problem["ft"]
    bump = get_test_function(support=[-problem["radius"], problem["radius"]],
                             slope=0.3)(ft.rs)
    rho0 = bump_density_guess(key, jnp.asarray(bump, dtype=jnp.float32),
                              (problem["N"], ft.sht.n_theta, ft.sht.n_phi),
                              snr=2.0, total_intensity=problem["total_intensity"],
                              integration_weights=jnp.asarray(np.asarray(problem["integ"]._w)))
    # FT roundtrip smoothing (reconstruct.py:963-966)
    return ft.inverse(ft.forward(rho0))


def test_phasing_converges_and_recovers_invariants(problem):
    mtip, ft = problem["mtip"], problem["ft"]
    schedule = [
        Segment('HIO', 40, betas=np.full(40, 0.5), ft_stab=True),
        Segment('SW', sigma=mtip.sw.default_sigma * 2, threshold=0.09),
        Segment('ER', 20, betas=np.zeros(20), ft_stab=True),
        Segment('SW', sigma=mtip.sw.default_sigma, threshold=0.09),
        Segment('ER', 40, betas=np.zeros(40), ft_stab=True),
    ]
    rho0 = _initial_density(problem, jax.random.PRNGKey(7))
    run = jax.jit(lambda r: mtip.run(r, schedule))
    state, errors = run(rho0)
    errors = np.asarray(errors)
    assert errors.shape[-1] == 2  # (main, reciprocal)
    assert np.isfinite(errors).all()
    errors = errors[:, 0]
    # convergence: final error well below the early-phase error
    assert errors[-1] < 0.1 * errors[:5].mean()
    assert errors[-1] < 5e-2

    # invariant fingerprint of the reconstruction matches the data
    rho_rec = state.best_rho
    psi = ft.forward(rho_rec)
    coeff = np.asarray(ft.sht.forward((psi * psi.conj()).real))
    bl_rec = itools.harmonic_coeff_to_deg2_invariants_3d(coeff)
    bl = problem["bl"]
    # lowest q shells systematically deviate (support/positivity corrections
    # inject low-q power; same behavior as the reference) — compare q>=4
    s = slice(4, None)
    for l in [0, 2, 4]:
        scale = np.abs(bl[l][s, s]).max()
        rel = np.abs(bl_rec[l][s, s] - bl[l][s, s]).max() / scale
        assert rel < 0.25, f"l={l}: invariant mismatch {rel}"

    # ground-truth fidelity in REAL space: center both, SO(3)-align the
    # reconstruction to the true density (inversion-aware), then require a
    # high normalized real-space correlation — the strongest end-to-end
    # parity statement (invariants are rotation-blind; this is not)
    from xframe_tpu.projects.fxs.alignment import Aligner
    from xframe_tpu.ops.integrate import SphericalIntegrator
    integ = problem["integ"]
    w = np.asarray(integ._w)
    aligner = Aligner(ft, w)
    rho_t = jnp.asarray(problem["rho_true"], dtype=jnp.complex64)
    rho_t_c, _ = aligner.center(rho_t)
    rho_r_c, _ = aligner.center(rho_rec)
    ref_coeff = aligner.coefficients(rho_t_c)
    rho_aligned, _, info = aligner.align(rho_r_c, ref_coeff,
                                         check_point_inversion=True)
    a = np.abs(np.asarray(rho_aligned))
    t = np.abs(np.asarray(rho_t_c))
    corr = float((w * a * t).sum()
                 / np.sqrt((w * a * a).sum() * (w * t * t).sum()))
    assert corr > 0.9, f"real-space correlation {corr}"


def test_multi_start_vmap(problem):
    mtip = problem["mtip"]
    schedule = [
        Segment('HIO', 10, betas=np.full(10, 0.5), ft_stab=True),
        Segment('SW', sigma=mtip.sw.default_sigma, threshold=0.09),
        Segment('ER', 5, betas=np.zeros(5), ft_stab=True),
    ]
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    rho0s = jnp.stack([_initial_density(problem, k) for k in keys])
    run = jax.jit(lambda r: mtip.run_batch(r, schedule))
    states, errors = run(rho0s)
    errors = np.asarray(errors)
    assert errors.shape == (4, 15, 2)
    assert np.isfinite(errors).all()
    errors = errors[..., 0]
    # restarts differ (independent RNG) but all make progress
    assert (errors[:, -1] < errors[:, 0]).all()
    assert len(np.unique(errors[:, -1])) == 4


def test_build_schedule_tutorial_shape():
    main_loop = {
        'order': ['main', 'refinement'],
        'main': {'iterations': 5, 'order': ['HIO', 'SW', 'ER'],
                 'methods': {'HIO': {'iterations': 60}, 'SW': {'iterations': 1},
                             'ER': {'iterations': 40}}},
        'refinement': {'iterations': 1, 'order': ['SW', 'ER'],
                       'methods': {'ER': {'iterations': 100}, 'SW': {'iterations': 1}}},
    }
    hio_betas = [[0.5, 0.4, -1 / 250, 500], [0.01, 0.002, -1 / 200, 200]]
    sw_sigmas = [[20, [False, 5], -2], False]
    sw_thresholds = [0.09, 0.09]
    ft_stab = {'main': {'HIO': True, 'ER': True}, 'refinement': {'ER': True}}
    segs = build_schedule(main_loop, hio_betas, sw_sigmas, sw_thresholds,
                          ft_stab, default_sigma=3.0)
    n_iter = sum(s.n for s in segs if s.method != 'SW')
    n_sw = sum(1 for s in segs if s.method == 'SW')
    assert n_iter == 5 * 100 + 100
    assert n_sw == 6
    # β ramp continues across iterations within a loop
    hio_segs = [s for s in segs if s.method == 'HIO']
    assert np.isclose(hio_segs[0].betas[0], 0.5)
    assert hio_segs[1].betas[0] < hio_segs[0].betas[-1]
    # SW σ ramp: starts at 20, decreasing, clamped at default σ
    sw_segs = [s for s in segs if s.method == 'SW']
    assert np.isclose(sw_segs[0].sigma, 20.0)
    assert np.isclose(sw_segs[1].sigma, 18.0)
    assert sw_segs[-2].sigma >= 3.0


def test_newton_schulz_procrustes_matches_svd(problem):
    """The matmul-only polar iteration must (a) produce near-unitary W on the
    valid block and (b) drive the phasing loop to the same convergence as the
    exact SVD path."""
    import jax.numpy as jnp
    from xframe_tpu.projects.fxs.projections import polar_unitary_newton_schulz
    mtip = problem["mtip"]
    rho0 = _initial_density(problem, jax.random.PRNGKey(3))
    psi = problem["ft"].forward(rho0)
    Ilm = problem["ft"].sht.forward((psi * psi.conj()).real)
    from dataclasses import replace as _replace
    rc = mtip.rc
    W_svd = np.asarray(rc.approximate_unknowns(Ilm))
    rc_ns_probe = _replace(rc, procrustes_method="newton_schulz",
                           ns_iterations=16)
    W_ns = np.asarray(rc_ns_probe.approximate_unknowns(Ilm))
    # l=16 has 2l+1 > n_q: the block is exactly singular and NS converges to
    # a partial isometry there (the SVD completion is arbitrary anyway)
    for l in [0, 2, 8]:
        w = W_ns[l]
        unitarity = np.abs(w.conj().T @ w - np.eye(w.shape[0])).max()
        assert unitarity < 5e-2, (l, unitarity)
    # same polar factor up to iteration tolerance on well-conditioned blocks
    rel = np.abs(W_ns[2] - W_svd[2]).max()
    assert rel < 0.1, rel

    # end-to-end: NS-based phasing converges like the SVD-based one
    from dataclasses import replace
    from xframe_tpu.projects.fxs.phasing import MTIP
    rc_ns = replace(rc, procrustes_method="newton_schulz", ns_iterations=16)
    mtip_ns = MTIP(problem["ft"], rc_ns, mtip.real, mtip.sw, mtip._w_err,
                   np.asarray(mtip.initial_support),
                   enforce_initial_support_limit=mtip.enforce_limit)
    schedule = [
        Segment('HIO', 30, betas=np.full(30, 0.5), ft_stab=True),
        Segment('SW', sigma=mtip.sw.default_sigma * 2, threshold=0.09),
        Segment('ER', 20, betas=np.zeros(20), ft_stab=True),
    ]
    run_ns = jax.jit(lambda r: mtip_ns.run(r, schedule))
    state, errors = run_ns(rho0)
    errors = np.asarray(errors)[:, 0]
    assert np.isfinite(errors).all()
    assert errors[-1] < 0.3 * errors[:5].mean()


def test_ns_bucketed_polar_matches_svd_multi_bucket():
    """At L ≥ 65 the NS polar path splits orders into multiple crop
    buckets (l ≤ 63 on 127-wide crops, l ≥ 64 on 255-wide crops); the
    result must match the exact SVD polar factor on every valid window."""
    from dataclasses import replace
    from xframe_tpu.projects.fxs.projections import ReciprocalConstraint
    rng = np.random.default_rng(7)
    L = 66
    n_q = 2 * L + 3  # > n_m so every order's B_l block is full-rank
    mats = [rng.normal(size=(n_q, min(2 * l + 1, n_q)))
            + 1j * rng.normal(size=(n_q, min(2 * l + 1, n_q)))
            for l in range(L + 1)]
    rc = ReciprocalConstraint.build(
        mats, radial_points=np.linspace(0.1, 1.0, n_q), l_max=L,
        odd_orders_to_0=False, use_averaged_intensity=False,
        schmidt_scaling=False)
    rc_ns = replace(rc, procrustes_method="newton_schulz", ns_iterations=16)
    assert rc_ns._ns_buckets() == [(0, 63, 63), (64, 65, 65)]
    n_m = 2 * L + 1
    Ilm = (rng.normal(size=(n_q, n_m, L + 1))
           + 1j * rng.normal(size=(n_q, n_m, L + 1))).astype(np.complex64)
    # the SHT coefficient layout is zero outside |m| <= l — that structure
    # is what makes the centered-window crop exact (B_l block-diagonal)
    for l in range(L + 1):
        Ilm[:, :L - l, l] = 0
        Ilm[:, L + l + 1:, l] = 0
    W_svd = np.asarray(jax.jit(rc.approximate_unknowns)(Ilm))
    W_ns = np.asarray(jax.jit(rc_ns.approximate_unknowns)(Ilm))
    for l in [2, 40, 63, 64, 65, 66]:  # samples from every bucket + l = L
        win = slice(L - l, L + l + 1)
        ref, got = W_svd[l][win, win], W_ns[l][win, win]
        assert np.abs(ref - got).max() < 5e-2, l
        # and identity outside the window
        out = W_ns[l].copy()
        out[win, win] = 0.0
        eye_out = np.eye(n_m, dtype=out.dtype)
        eye_out[win, win] = 0.0
        np.testing.assert_allclose(out, eye_out, atol=1e-5)


def test_checkpointing_runner_resumes(problem, tmp_path):
    """Chunked runner: (a) produces the same trajectory as the monolithic
    run, (b) resumes from a mid-run snapshot, (c) reuses compilations for
    identical chunk structures."""
    from xframe_tpu.parallel.mesh import CheckpointingRunner
    mtip = problem["mtip"]
    schedule = [
        Segment('HIO', 8, betas=np.linspace(0.5, 0.45, 8), ft_stab=True),
        Segment('SW', sigma=mtip.sw.default_sigma, threshold=0.09),
        Segment('ER', 4, betas=np.zeros(4), ft_stab=True),
        Segment('HIO', 8, betas=np.linspace(0.45, 0.4, 8), ft_stab=True),
        Segment('SW', sigma=mtip.sw.default_sigma, threshold=0.09),
        Segment('ER', 4, betas=np.zeros(4), ft_stab=True),
    ]
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    rho0s = jnp.stack([_initial_density(problem, k) for k in keys])

    # monolithic reference trajectory
    run = jax.jit(lambda r: mtip.run_batch(r, schedule))
    states_ref, errors_ref = run(rho0s)
    errors_ref = np.asarray(errors_ref)

    ckpt = str(tmp_path / "phasing_checkpoint.h5")
    runner = CheckpointingRunner(mtip, schedule, checkpoint_path=ckpt)
    states, errors = runner(rho0s)
    errors = np.asarray(errors)
    assert errors.shape == errors_ref.shape
    assert np.allclose(errors, errors_ref, rtol=1e-3, atol=1e-6)
    # chunks: [HIO,SW], [ER,HIO,SW], [ER] → 3 distinct structures; a longer
    # loop repeating [ER,HIO,SW] would add no further compilations
    assert len(runner._compiled) == 3
    import os
    assert os.path.exists(ckpt)

    # true mid-run resume: interrupt after chunk 1, then a FRESH runner picks
    # up from the snapshot and must land on the reference trajectory
    ckpt2 = str(tmp_path / "interrupted.h5")
    runner_a = CheckpointingRunner(mtip, schedule, checkpoint_path=ckpt2)
    runner_a(rho0s, max_chunks=1)
    runner_b = CheckpointingRunner(mtip, schedule, checkpoint_path=ckpt2)
    states_r, errors_r = runner_b(rho0s)
    errors_r = np.asarray(errors_r)
    assert errors_r.shape == errors_ref.shape
    # float32 snapshot roundtrip: trajectories agree to single precision
    assert np.allclose(errors_r, errors_ref, rtol=5e-2, atol=1e-5)
    assert np.allclose(np.asarray(states_r.best_err),
                       np.asarray(states_ref.best_err), rtol=5e-2)


def test_sw_center_recentering(problem):
    """SW_center re-centers an off-center density (SW alone does not)."""
    from xframe_tpu.library.shapes import (spherical_grid,
                                           spherical_to_cartesian)
    mtip, ft = problem["mtip"], problem["ft"]
    grid_r = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)
    grid_q = spherical_grid(ft.qs, ft.sht.theta, ft.sht.phi)
    mtip.enable_centering(spherical_to_cartesian(grid_r),
                          spherical_to_cartesian(grid_q))
    from xframe_tpu.library.shapes import ball_density
    radius = problem["radius"]
    rho_off = jnp.asarray(ball_density(grid_r, radius / 3,
                                       center=(radius / 2, 1.3, 0.6)),
                          dtype=jnp.complex64)
    state = mtip.initial_state(rho_off)
    seg = Segment("SW_center", sigma=mtip.sw.default_sigma, threshold=0.1)
    out = jax.jit(lambda st: mtip._shrink_wrap(st, seg))(state)
    r_cart = spherical_to_cartesian(grid_r)
    w_off = np.abs(np.asarray(rho_off))
    w_new = np.abs(np.asarray(out.rho))
    com_off = np.einsum("rtpc,rtp->c", r_cart, w_off) / w_off.sum()
    com_new = np.einsum("rtpc,rtp->c", r_cart, w_new) / w_new.sum()
    assert np.linalg.norm(com_new) < 0.25 * np.linalg.norm(com_off)


def test_sw_center_through_multi_start_runner(problem):
    """SW_center segments must survive the jitted MTIP.run path that
    MultiStartRunner (the default reconstruct worker path) compiles —
    regression for the r1 dispatch bug where run() only matched 'SW' and
    crashed on betas=None."""
    from xframe_tpu.parallel.mesh import MultiStartRunner
    from xframe_tpu.library.shapes import spherical_to_cartesian
    mtip, ft = problem["mtip"], problem["ft"]
    grid_r = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)
    grid_q = spherical_grid(ft.qs, ft.sht.theta, ft.sht.phi)
    mtip.enable_centering(spherical_to_cartesian(grid_r),
                          spherical_to_cartesian(grid_q))
    schedule = [
        Segment('HIO', 6, betas=np.full(6, 0.5), ft_stab=True),
        Segment('SW_center', sigma=mtip.sw.default_sigma, threshold=0.09),
        Segment('ER', 4, betas=np.zeros(4), ft_stab=True),
    ]
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    rho0s = jnp.stack([_initial_density(problem, k) for k in keys])
    states, errors = MultiStartRunner(mtip, schedule, mesh=None)(rho0s)
    errors = np.asarray(errors)
    assert errors.shape == (2, 10, 2)
    assert np.isfinite(errors).all()
    assert (errors[:, -1, 0] < errors[:, 0, 0]).all()


def test_fixed_volume_shrink_wrap(problem):
    """mode='fixed_volume': the new support's integrated volume must hit the
    target fraction of the initial-support volume (reference
    fxs_Projections.py:260-283 via golden-section; here exact quantile),
    both standalone and through a full jitted schedule."""
    from xframe_tpu.projects.fxs.projections import ShrinkWrap
    mtip, ft, integ = problem["mtip"], problem["ft"], problem["integ"]
    init_sup = np.asarray(mtip.initial_support)
    w = np.asarray(integ._w)
    frac = 0.37
    sw_fv = ShrinkWrap.build(ft.qs, mode="fixed_volume", volume_fraction=frac,
                             integration_weights=w, initial_support=init_sup)

    # standalone: blur of a ball density
    grid = problem["grid"]
    rho = jnp.asarray(ball_density(grid, problem["radius"] / 2),
                      dtype=jnp.complex64)
    blurred = ft.inverse(ft.forward(jnp.abs(rho).astype(jnp.complex64))
                         * sw_fv.gaussian_values(sw_fv.default_sigma))
    mask = np.asarray(jax.jit(sw_fv.new_support_fixed_volume)(blurred))
    vol0 = (w * init_sup).sum()
    vol = (w * mask).sum()
    assert abs(vol / vol0 - frac) < 0.02, vol / vol0
    assert not (mask & ~init_sup.astype(bool)).any()

    # through the jitted run path: each SW event is rate-limited to a 20%
    # volume change of the current support (reference d_vol_thresh,
    # fxs_Projections.py:270-283), so one event lands on 0.8·vol0 ...
    mtip_fv = MTIP(problem["ft"], mtip.rc, mtip.real, sw_fv, mtip._w_err,
                   init_sup, enforce_initial_support_limit=mtip.enforce_limit)
    schedule = [
        Segment('HIO', 8, betas=np.full(8, 0.5), ft_stab=True),
        Segment('SW', sigma=mtip.sw.default_sigma, threshold=0.09),
        Segment('ER', 4, betas=np.zeros(4), ft_stab=True),
    ]
    rho0 = _initial_density(problem, jax.random.PRNGKey(2))
    state, errors = jax.jit(lambda r: mtip_fv.run(r, schedule))(rho0)
    vol_run = (w * np.asarray(state.support)).sum()
    assert abs(vol_run / vol0 - 0.8) < 0.02, vol_run / vol0
    assert np.isfinite(np.asarray(errors)).all()

    # ... and repeated events converge geometrically onto the target:
    # 0.8 → 0.64 → 0.512 → 0.41 → clip(0.41·[0.8,1.2] ∋ 0.37) = 0.37
    schedule_5sw = []
    for _ in range(5):
        schedule_5sw += [
            Segment('HIO', 2, betas=np.full(2, 0.5), ft_stab=True),
            Segment('SW', sigma=mtip.sw.default_sigma, threshold=0.09)]
    state5, _ = jax.jit(lambda r: mtip_fv.run(r, schedule_5sw))(rho0)
    vol5 = (w * np.asarray(state5.support)).sum()
    assert abs(vol5 / vol0 - frac) < 0.02, vol5 / vol0

    # max_volume_change=None jumps straight to the target in one event
    sw_nolim = ShrinkWrap.build(ft.qs, mode="fixed_volume",
                                volume_fraction=frac, integration_weights=w,
                                initial_support=init_sup,
                                max_volume_change=None)
    mtip_nl = MTIP(problem["ft"], mtip.rc, mtip.real, sw_nolim, mtip._w_err,
                   init_sup, enforce_initial_support_limit=mtip.enforce_limit)
    state_nl, _ = jax.jit(lambda r: mtip_nl.run(r, schedule))(rho0)
    vol_nl = (w * np.asarray(state_nl.support)).sum()
    assert abs(vol_nl / vol0 - frac) < 0.02, vol_nl / vol0


def test_run_batch_with_arg_tables_matches_embedded():
    """Production-scale payload path: threading every big table (Hankel,
    Legendre, projection matrices, initial support) into jit as ARGUMENTS
    (mtip.arg_tables +
    run_batch(tables=...)) must reproduce the embedded-constant run
    bitwise — the only difference is where the bytes live in the compiled
    artifact."""
    from xframe_tpu.projects.fxs.demo import make_demo_problem
    p = make_demo_problem(16, 8)
    sched = [Segment("HIO", 4, betas=np.full(4, 0.5), ft_stab=True),
             Segment("SW", sigma=p.mtip.sw.default_sigma, threshold=0.1),
             Segment("ER", 2, betas=np.zeros(2), ft_stab=True)]
    tables = p.mtip.arg_tables()
    assert set(tables) == {"h_wf_re", "h_wf_im", "h_wi_re", "h_wi_im",
                           "sht_P_e", "sht_P_o", "sht_PW_e", "sht_PW_o",
                           "rc_V_re", "rc_V_im", "rc_PD_re", "rc_PD_im",
                           "initial_support"}
    rho0s = p.initial_density_batch(3, 2)
    rho0s_t = p.initial_density_batch(3, 2, tables=tables)
    np.testing.assert_array_equal(np.asarray(rho0s), np.asarray(rho0s_t))

    st_ref, err_ref = jax.jit(lambda r: p.mtip.run_batch(r, sched))(rho0s)
    st_tab, err_tab = jax.jit(
        lambda t, r: p.mtip.run_batch(r, sched, tables=t))(tables, rho0s)
    np.testing.assert_array_equal(np.asarray(err_ref), np.asarray(err_tab))
    np.testing.assert_array_equal(np.asarray(st_ref.rho),
                                  np.asarray(st_tab.rho))
    # the host objects were restored after tracing (no tracer leakage)
    assert isinstance(p.mtip.ft.hankel._wf, np.ndarray)
    assert isinstance(p.mtip.ft.sht._PW_e, np.ndarray)
    assert isinstance(p.mtip.rc.V_pad, np.ndarray)
    assert isinstance(p.mtip.initial_support, np.ndarray)


def test_fixed_volume_bucketed_matches_sort():
    """The bucketed (histogram-refinement) fixed-volume selection must
    reproduce the exact sort-based mask on generic data, land on the target
    volume under heavy value degeneracy (quantized blur: rank tie-break),
    and never overshoot by more than one point's weight."""
    from xframe_tpu.projects.fxs.projections import (
        ShrinkWrap, _fixed_volume_keep_bucketed)
    rng = np.random.default_rng(7)
    shape = (24, 18, 36)
    conv = jnp.asarray(rng.gamma(2.0, 1.0, size=shape).astype(np.float32))
    w_int = rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
    init = np.ones(shape, bool)
    for frac in (0.1, 0.37, 0.8):
        kw = dict(mode="fixed_volume", volume_fraction=frac,
                  integration_weights=w_int, initial_support=init)
        sw_s = ShrinkWrap.build(np.linspace(0.01, 1, 24), **kw)
        sw_b = ShrinkWrap.build(np.linspace(0.01, 1, 24), **kw,
                                fixed_volume_method="bucketed")
        m_s = np.asarray(jax.jit(sw_s.new_support_fixed_volume)(conv))
        m_b = np.asarray(jax.jit(sw_b.new_support_fixed_volume)(conv))
        assert (m_s == m_b).all(), f"frac={frac}: masks differ"

    # heavy ties: 8-level quantized values — the sort path breaks ties by
    # rank; bucketed must still hit the target within one point's weight
    conv_q = jnp.asarray(
        np.floor(rng.uniform(0, 8, size=shape)).astype(np.float32))
    target = 0.5 * w_int.sum()
    keep = np.asarray(jax.jit(
        lambda c: _fixed_volume_keep_bucketed(
            c.ravel(), jnp.asarray(w_int.ravel()), target))(conv_q))
    vol = (w_int.ravel() * keep).sum()
    assert 0 <= vol - target < w_int.max() * 1.001, (vol, target)
    # all-equal degenerate input: still well-formed, same volume contract
    keep_eq = np.asarray(jax.jit(
        lambda c: _fixed_volume_keep_bucketed(
            c.ravel(), jnp.asarray(w_int.ravel()), target))(
        jnp.ones(shape, jnp.float32)))
    vol_eq = (w_int.ravel() * keep_eq).sum()
    assert 0 <= vol_eq - target < w_int.max() * 1.001, (vol_eq, target)


def test_initial_density_batch_key_seed_with_tables():
    """initial_density_batch accepts a PRNG key array (documented form) on
    BOTH the plain and the tables-as-arguments path, and the tables path
    reproduces the embedded-constant guess bit-for-bit."""
    from xframe_tpu.projects.fxs.demo import make_demo_problem
    p = make_demo_problem(12, 6)
    tables = p.mtip.arg_tables()
    a = np.asarray(p.initial_density_batch(3, 2))
    b = np.asarray(p.initial_density_batch(3, 2, tables=tables))
    assert np.array_equal(a, b)
    key = jax.random.PRNGKey(3)
    c = np.asarray(p.initial_density_batch(key, 2))
    d = np.asarray(p.initial_density_batch(key, 2, tables=tables))
    assert np.array_equal(c, d)
    assert c.shape == a.shape
