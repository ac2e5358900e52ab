"""Scientific fidelity gate: does the reconstructed density match the known
ground truth?

Every pipeline artifact test (ours and the reference's,
reference tests/test_fxs_integration.py) asserts schemas and finiteness —
never that the phased density IS the simulated object. This module makes
that claim checkable: build the analytic ground-truth density of the
simulate_ccd shape configuration on the reconstruction's internal grid,
SO(3)-align the reconstructed/averaged density to it (FXS reconstructions
carry a global rotation + point-inversion + scale ambiguity — alignment and
a normalized metric remove exactly those), and report the real-space
correlation

    corr = Σ w·ρ_a·ρ_t / sqrt(Σ w·ρ_a² · Σ w·ρ_t²),   ρ = |real part|

with w the spherical/polar integration weights. 1.0 = perfect, 0 = noise.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def density_correlation(a, b, weights):
    """Normalized weighted real-space correlation of two densities (host)."""
    a = np.abs(np.real(np.asarray(a))).astype(np.float64)
    b = np.abs(np.real(np.asarray(b))).astype(np.float64)
    w = np.asarray(weights, dtype=np.float64)
    w = np.broadcast_to(w, a.shape)
    num = float((w * a * b).sum())
    den = float(np.sqrt((w * a * a).sum() * (w * b * b).sum()))
    return num / max(den, 1e-300)


def ground_truth_density(shapes_opt, ft, dim=3):
    """The simulate_ccd shape configuration evaluated on ft's REAL grid."""
    from xframe_tpu.projects.fxs.simulate_ccd import build_density_from_shapes
    from xframe_tpu.library.shapes import spherical_grid, polar_grid
    if dim == 3:
        grid = spherical_grid(ft.rs, ft.sht.theta, ft.sht.phi)
    else:
        phis = 2 * np.pi * np.arange(ft.n_phi) / ft.n_phi
        grid = polar_grid(ft.rs, phis)
    return np.asarray(build_density_from_shapes(grid, shapes_opt),
                      dtype=np.float64)


def align_to_ground_truth(density, shapes_opt, ft, integration_weights,
                          dim=3, l_max_align=None, center=True):
    """Align `density` (host array on ft's real grid) to the analytic ground
    truth of `shapes_opt`; → (correlation, aligned density, truth density).

    The rotation search runs through the same Aligner the average worker
    uses (SO(3) correlation + point-inversion disambiguation); both inputs
    are centered first (the reconstruction's translational gauge)."""
    truth = ground_truth_density(shapes_opt, ft, dim=dim)
    if dim == 3:
        from xframe_tpu.projects.fxs.alignment import Aligner
        aligner = Aligner(ft, integration_weights, l_max_align=l_max_align)
    else:
        from xframe_tpu.projects.fxs.alignment import Aligner2D
        aligner = Aligner2D(ft, integration_weights)
    truth_d = jnp.asarray(truth.astype(np.complex64))
    cand_d = jnp.asarray(np.asarray(density).astype(np.complex64))
    if center:
        truth_d = aligner.center(truth_d)[0]
        cand_d = aligner.center(cand_d)[0]
    ref_coeff = aligner.coefficients(truth_d)
    rot, _, _, _ = aligner.align_batch(
        jax.jit(lambda x: x[None])(cand_d), ref_coeff, ref_rho=truth_d,
        check_point_inversion=True)
    aligned = np.asarray(np.asarray(jax.jit(lambda r: r[0])(rot)))
    truth_h = np.asarray(np.asarray(truth_d))
    corr = density_correlation(aligned, truth_h, integration_weights)
    return corr, aligned, truth_h
