"""Self-contained synthetic MTIP problem builder.

Builds the full phasing setup (transforms, invariants of a known two-ball
density, reciprocal/real constraints, shrink-wrap) at any scale — the backbone
of `__graft_entry__.py`, `bench.py`, and the phasing tests. Mirrors what the
reconstruct worker assembles from settings + an invariants file
(reference reconstruct.py:241-316), but sources the projection data from an
analytic density so it needs no input files.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp

from xframe_tpu.ops.fourier import SphericalFourierTransform, PolarFourierTransform
from xframe_tpu.ops.integrate import SphericalIntegrator, PolarIntegrator
from xframe_tpu.library.shapes import (spherical_grid, polar_grid, ball_density,
                                       get_test_function)
from xframe_tpu.projects.fxs import invariants as itools
from xframe_tpu.projects.fxs.projections import (
    ReciprocalConstraint, ReciprocalConstraintPolar, RealCircularHarmonics,
    RealConstraint, ShrinkWrap,
)
from xframe_tpu.projects.fxs.phasing import MTIP, bump_density_guess


def make_demo_problem(n_radial: int = 32, l_max: int = 16, *, q_max: float = None,
                      n_theta: int = None, n_phi: int = None, mode: str = "midpoint",
                      reciprocity_coefficient: float = 2.0,
                      real_dtype=jnp.float32,
                      procrustes_method: str = "svd",
                      ns_iterations: int = 16, ns_schedule=None,
                      cache_weights: bool = False) -> SimpleNamespace:
    """Two-ball density → invariants → MTIP, plus initial-density helpers.

    cache_weights=True routes the Hankel weight assembly through the same
    disk cache the reconstruct worker uses (keyed by N/L/rc/mode under
    <home>/cache) — at production scale the host assembly takes minutes,
    so repeated bench/A-B invocations should not redo it."""
    if q_max is None:
        q_max = 0.4 * n_radial / 32.0
    weights_dict = None
    if cache_weights:
        from xframe_tpu.projects.fxs.reconstruct import load_cached_weights
        weights_dict = load_cached_weights(
            l_max, n_radial, reciprocity_coefficient, 3, mode)
    ft = SphericalFourierTransform(n_radial, l_max, q_max=q_max, mode=mode,
                                   reciprocity_coefficient=reciprocity_coefficient,
                                   n_theta=n_theta, n_phi=n_phi,
                                   real_dtype=real_dtype,
                                   weights_dict=weights_dict)
    cdtype = jnp.complex64 if real_dtype == jnp.float32 else jnp.complex128
    grid = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)
    radius = ft.r_max / 2.2
    rho_true = ball_density(grid, radius / 2.5, center=(radius / 2, 1.2, 0.7)) \
        + 0.7 * ball_density(grid, radius / 3.0, center=(radius / 2.2, 2.1, 3.9))

    # data side: B_l of the true density → projection matrices V_l
    np_real = np.float32 if real_dtype == jnp.float32 else np.float64

    @jax.jit
    def data_coeff(rho_real):
        psi = ft.forward(rho_real.astype(cdtype))
        return ft.sht.forward((psi * psi.conj()).real)

    coeff = np.asarray(data_coeff(np.asarray(rho_true, dtype=np_real)))
    bl = itools.harmonic_coeff_to_deg2_invariants_3d(coeff).real.astype(complex)
    bl[1::2] = 0  # Friedel symmetry
    proj, eigs = itools.deg2_invariant_to_projection_matrices(bl)
    avg_intensity = np.sqrt(np.maximum(np.diag(bl[0]).real, 0.0) / (4 * np.pi))
    total_intensity = float(np.trapezoid(avg_intensity * ft.qs ** 2, ft.qs)
                            * 2 * np.sqrt(np.pi))

    integ = SphericalIntegrator(ft.rs, ft.sht.n_theta, ft.sht.n_phi,
                                real_dtype=real_dtype)
    initial_support = grid[..., 0] < radius * 1.2
    rc = ReciprocalConstraint.build(proj, ft.qs, l_max,
                                    use_averaged_intensity=True,
                                    average_intensity=avg_intensity,
                                    odd_orders_to_0=True, schmidt_scaling=False,
                                    real_dtype=real_dtype,
                                    procrustes_method=procrustes_method,
                                    ns_iterations=ns_iterations,
                                    ns_schedule=ns_schedule)
    real = RealConstraint(limit_imag=2.0)
    sw = ShrinkWrap.build(ft.qs, real_dtype=real_dtype)
    # separable (n_r, n_θ, 1) weights: MTIP masks by the support in-trace,
    # keeping the grid-sized product out of the compiled payload
    mtip = MTIP(ft, rc, real, sw, integ.w_broadcast, initial_support,
                enforce_initial_support_limit=6e-3, real_dtype=real_dtype)

    np_real = np.float32 if real_dtype == jnp.float32 else np.float64
    bump = get_test_function(support=[-radius, radius], slope=0.3)(ft.rs)
    bump = np.asarray(bump, dtype=np_real)
    w_full = np.asarray(integ.w_broadcast)
    shape = (n_radial, ft.sht.n_theta, ft.sht.n_phi)

    def _guess(key):
        """Random bump guess + FT-roundtrip smoothing (reconstruct.py:963-966)."""
        rho0 = bump_density_guess(key, bump, shape, snr=2.0,
                                  total_intensity=total_intensity,
                                  integration_weights=w_full, cdtype=cdtype)
        return ft.inverse(ft.forward(rho0))

    initial_density = jax.jit(_guess)

    from functools import partial

    @partial(jax.jit, static_argnums=(1,))
    def _batch_from_seed(seed, n_restarts):
        # seed is TRACED (fresh seeds reuse one compilation, as in the
        # reconstruct worker)
        key = jax.random.PRNGKey(seed)
        return jax.vmap(_guess)(jax.random.split(key, n_restarts))

    @partial(jax.jit, static_argnums=1)
    def _batch_from_key(key, n_restarts):
        return jax.vmap(_guess)(jax.random.split(key, n_restarts))

    @partial(jax.jit, static_argnums=(2,))
    def _batch_from_seed_tables(tables, seed, n_restarts):
        # production scale: the guess's FT roundtrip references the Hankel
        # tables, which enter as arguments (see ft.arg_tables)
        with ft.bound_tables(tables):
            key = jax.random.PRNGKey(seed)
            return jax.vmap(_guess)(jax.random.split(key, n_restarts))

    @partial(jax.jit, static_argnums=(2,))
    def _batch_from_key_tables(tables, key, n_restarts):
        with ft.bound_tables(tables):
            return jax.vmap(_guess)(jax.random.split(key, n_restarts))

    def initial_density_batch(seed, n_restarts, tables=None):
        """seed: python int (one compilation for all seeds) or a PRNG key
        array."""
        if tables is not None:
            if isinstance(seed, (int, np.integer)):
                return _batch_from_seed_tables(tables, int(seed), n_restarts)
            return _batch_from_key_tables(tables, seed, n_restarts)
        if isinstance(seed, (int, np.integer)):
            return _batch_from_seed(int(seed), n_restarts)
        return _batch_from_key(seed, n_restarts)

    return SimpleNamespace(
        ft=ft, mtip=mtip, grid=grid, rho_true=rho_true, bl=bl,
        projection_matrices=proj, eigenvalues=eigs,
        average_intensity=avg_intensity, total_intensity=total_intensity,
        radius=radius, integrator=integ, initial_support=initial_support,
        initial_density=initial_density,
        initial_density_batch=initial_density_batch,
    )


def make_demo_problem_2d(n_radial: int = 32, m_max: int = 16, n_phi: int = 64,
                         *, q_max: float = None, mode: str = "midpoint",
                         reciprocity_coefficient: float = 2.0,
                         real_dtype=jnp.float32) -> SimpleNamespace:
    """Two-disk 2D (polar) MTIP problem, mirroring make_demo_problem."""
    if q_max is None:
        q_max = 0.4 * n_radial / 32.0
    ft = PolarFourierTransform(n_radial, m_max, n_phi, q_max, mode=mode,
                               reciprocity_coefficient=reciprocity_coefficient,
                               real_dtype=real_dtype)
    cdtype = jnp.complex64 if real_dtype == jnp.float32 else jnp.complex128
    np_real = np.float32 if real_dtype == jnp.float32 else np.float64
    phis = 2 * np.pi * np.arange(n_phi) / n_phi
    grid = polar_grid(ft.rs, phis)
    radius = ft.r_max / 2.2
    rho_true = ball_density(grid, radius / 2.5, center=(radius / 2, 0.7)) \
        + 0.7 * ball_density(grid, radius / 3.0, center=(radius / 2.2, 3.9))

    cht = RealCircularHarmonics(n_phi, m_max)

    @jax.jit
    def data_coeff(rho_real):
        psi = ft.forward(rho_real.astype(cdtype))
        return cht.forward((psi * psi.conj()).real)

    coeff = np.asarray(data_coeff(np.asarray(rho_true, dtype=np_real)))
    bm = itools.harmonic_coeff_to_deg2_invariants_2d(coeff)
    bm[1::2] = 0  # Friedel
    vecs, eigs = itools.deg2_invariant_to_projection_vectors_2d(bm)
    avg_intensity = coeff[:, 0].real
    total_intensity = float(np.trapezoid(avg_intensity * ft.qs, ft.qs) * 2 * np.pi)

    integ = PolarIntegrator(ft.rs, n_phi, real_dtype=real_dtype)
    initial_support = grid[..., 0] < radius * 1.2
    rc = ReciprocalConstraintPolar.build(
        list(vecs), ft.qs, m_max, use_averaged_intensity=True,
        average_intensity=avg_intensity, odd_orders_to_0=True,
        real_dtype=real_dtype)
    real = RealConstraint(limit_imag=2.0)
    sw = ShrinkWrap.build(ft.qs, grid_rank=2, real_dtype=real_dtype)
    w_err = np.asarray(integ._w) * initial_support
    mtip = MTIP(ft, rc, real, sw, w_err, initial_support,
                enforce_initial_support_limit=6e-3, real_dtype=real_dtype,
                harmonic=cht)

    bump = np.asarray(get_test_function(support=[-radius, radius],
                                        slope=0.3)(ft.rs), dtype=np_real)
    w_full = np.asarray(integ._w)
    shape = (n_radial, n_phi)

    def _guess(key):
        rho0 = bump_density_guess(key, bump, shape, snr=2.0,
                                  total_intensity=total_intensity,
                                  integration_weights=w_full, cdtype=cdtype)
        return ft.inverse(ft.forward(rho0))

    initial_density = jax.jit(_guess)

    from functools import partial

    @partial(jax.jit, static_argnums=(0, 1))
    def _batch_from_seed(seed, n_restarts):
        key = jax.random.PRNGKey(seed)
        return jax.vmap(_guess)(jax.random.split(key, n_restarts))

    def initial_density_batch(seed, n_restarts):
        return _batch_from_seed(int(seed), n_restarts)

    return SimpleNamespace(
        ft=ft, mtip=mtip, grid=grid, rho_true=rho_true, bm=bm, cht=cht,
        projection_vectors=vecs, eigenvalues=eigs,
        average_intensity=avg_intensity, total_intensity=total_intensity,
        radius=radius, integrator=integ, initial_support=initial_support,
        initial_density=initial_density,
        initial_density_batch=initial_density_batch,
    )
