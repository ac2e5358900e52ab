"""Minimax Newton-Schulz coefficient schedule (ops/polar_schedule.py).

The schedule replaces the fixed 16-quintic + 4-cubic polar iteration in the
MTIP Procrustes step (reference fxs_Projections.py:752-790 uses an exact SVD)
with 14 interval-optimal minimax steps at the same pinned unitarity — a 1.87x
arithmetic cut of the iteration's largest FLOP block at production scale.
"""
import numpy as np
import pytest

from xframe_tpu.ops.polar_schedule import (
    DEFAULT_SCHEDULE,
    apply_schedule_numpy,
    default_or_computed_schedule,
    polar_express_schedule,
)


def _scalar_apply(sched, x):
    """Schedule applied to scalar singular values (the diagonal action)."""
    for a, b, c in sched:
        x = a * x + b * x ** 3 + c * x ** 5
    return x


def test_default_schedule_matches_generator():
    """The baked literal must be exactly what the LP generator produces for
    the default (sigma_min=1e-7, target=1e-6) parameters."""
    gen = polar_express_schedule(1e-7, 1e-6)
    assert len(gen) == len(DEFAULT_SCHEDULE)
    np.testing.assert_allclose(np.asarray(gen), np.asarray(DEFAULT_SCHEDULE),
                               rtol=1e-12, atol=0.0)
    # the fast path returns the literal object itself
    assert default_or_computed_schedule(1e-7, 1e-6) is DEFAULT_SCHEDULE


def test_scalar_contraction_and_positivity():
    """Every singular value in [sigma_min, 1] lands within the 1e-6 target,
    and no intermediate step can cross zero (sign preservation — the same
    safety argument as for the fixed scheme)."""
    x = np.concatenate([
        np.geomspace(1e-7, 1.0, 5001),
        np.linspace(1e-7, 1.0, 5001),
        [1e-7, 1.0, 1.0 + 0.02],  # the 2% margin band is also controlled
    ])
    cur = x.copy()
    for a, b, c in DEFAULT_SCHEDULE:
        cur = a * cur + b * cur ** 3 + c * cur ** 5
        assert (cur > 0).all()
    assert np.abs(1.0 - cur).max() < 1e-6
    # below the assumed sigma_min: slower convergence, never divergence
    tiny = _scalar_apply(DEFAULT_SCHEDULE, np.array([1e-9, 1e-8]))
    assert (tiny > 0).all() and (tiny < 1.0 + 1e-4).all()


def test_numpy_matrix_polar_matches_svd_f64():
    """On an ill-conditioned complex matrix (sigma spanning [1e-6, 1] after
    normalization) the schedule's polar factor matches the exact SVD polar
    factor to near the pinned target in f64."""
    rng = np.random.default_rng(11)
    n = 40
    u, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    v, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    s = np.geomspace(1e-6, 1.0, n)
    M = (u * s) @ v.conj().T
    # the production caller normalizes by an upper bound of the spectral norm;
    # emulate with the same sqrt(L1*Linf) bound
    a = np.abs(M)
    nrm = np.sqrt(a.sum(0).max() * a.sum(1).max())
    W = apply_schedule_numpy(M / nrm, DEFAULT_SCHEDULE)
    W_exact = u @ v.conj().T
    assert np.abs(W - W_exact).max() < 1e-5
    assert np.abs(W.conj().T @ W - np.eye(n)).max() < 1e-5


def test_jnp_schedule_path_matches_numpy():
    """projections.polar_unitary_newton_schulz(schedule=...) (the lax.scan
    path) reproduces the host application in f64 and
    stays unitary in complex64 (the margin band absorbs f32 matmul noise)."""
    import jax
    import jax.numpy as jnp
    from xframe_tpu.projects.fxs.projections import polar_unitary_newton_schulz

    rng = np.random.default_rng(5)
    n = 24
    M = rng.normal(size=(3, n, n)) + 1j * rng.normal(size=(3, n, n))
    with jax.enable_x64(True):
        W = np.asarray(polar_unitary_newton_schulz(
            jnp.asarray(M, dtype=jnp.complex128), schedule=DEFAULT_SCHEDULE))
    for k in range(3):
        u, _, vh = np.linalg.svd(M[k])
        assert np.abs(W[k] - u @ vh).max() < 1e-5

    W32 = np.asarray(polar_unitary_newton_schulz(
        jnp.asarray(M, dtype=jnp.complex64), schedule=DEFAULT_SCHEDULE))
    for k in range(3):
        w = W32[k]
        assert np.abs(w.conj().T @ w - np.eye(n)).max() < 2e-3


def test_resolve_ns_schedule_modes():
    """Settings plumbing: 'minimax' (default) yields the baked schedule,
    'fixed' yields None (the fixed 16+4 iteration), junk raises."""
    from xframe_tpu.projects.fxs.reconstruct import _resolve_ns_schedule
    assert _resolve_ns_schedule({}) is DEFAULT_SCHEDULE
    assert _resolve_ns_schedule({"ns_coefficients": "fixed"}) is None
    got = _resolve_ns_schedule({"ns_coefficients": "minimax"})
    assert got is DEFAULT_SCHEDULE
    with pytest.raises(ValueError):
        _resolve_ns_schedule({"ns_coefficients": "banana"})
