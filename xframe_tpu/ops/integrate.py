"""Quadrature on polar/spherical grids as jit-able reductions.

Rebuilt from the reference integrators (mathLibrary.py:1212-1294): spherical
grids use Gauss-Legendre weights in θ, uniform φ, trapezoid in r; kept
numerically identical so error metrics match the reference.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from xframe_tpu.library.legendre import gauss_legendre


def _trapz_weights(x):
    x = np.asarray(x, dtype=np.float64)
    w = np.zeros_like(x)
    dx = np.diff(x)
    w[:-1] += dx / 2
    w[1:] += dx / 2
    return w


class SphericalIntegrator:
    """∫ f(r,θ,φ) r² dr dΩ over an (n_r, n_θ, n_φ) grid
    (reference mathLibrary.py:1212-1240)."""

    def __init__(self, rs: np.ndarray, n_theta: int, n_phi: int, real_dtype=jnp.float32):
        rs = np.asarray(rs, dtype=np.float64)
        _, w_theta = gauss_legendre(n_theta)
        r_w = _trapz_weights(rs) * rs ** 2
        # full separable weight: (π/n_theta from dφ sum? — reference: π/n · Σ_φ)
        # reference integrate: (π/n_θ)·Σ_φ then GL in θ then trapz r²dr.
        np_real = np.float32 if real_dtype == jnp.float32 else np.float64
        # φ-constant separable weights: keep the (n_r, n_θ, 1) broadcast form
        # — at production scale the dense grid is a 100s-of-MB array that
        # must NOT become an embedded jit constant (it would bloat every
        # compiled program); `_w` stays a dense VIEW for shape-
        # strict consumers (einsums, ravel)
        self.w_broadcast = np.asarray(
            r_w[:, None, None] * w_theta[None, :, None] * (np.pi / n_theta),
            dtype=np_real)
        self._w = np.broadcast_to(self.w_broadcast,
                                  self.w_broadcast.shape[:2] + (n_phi,))
        self.max_r = float(rs.max())
        self.norm = 4 / 3 * np.pi * self.max_r ** 3

    def integrate(self, values):
        return jnp.sum(self._w * values, axis=(-3, -2, -1))

    def integrate_normed(self, values):
        return self.integrate(values) / self.norm

    def l2_norm(self, values):
        return self.integrate((values * jnp.conj(values)).real)


class PolarIntegrator:
    """∫ f(r,φ) r dr dφ over an (n_r, n_φ) grid (mathLibrary.py:1242-1267)."""

    def __init__(self, rs: np.ndarray, n_phi: int, real_dtype=jnp.float32):
        rs = np.asarray(rs, dtype=np.float64)
        phis = 2 * np.pi * np.arange(n_phi) / n_phi
        w = (_trapz_weights(rs) * rs)[:, None] * _trapz_weights(phis)[None, :]
        np_real = np.float32 if real_dtype == jnp.float32 else np.float64
        self._w = np.asarray(w, dtype=np_real)
        self.max_r = float(rs.max())
        self.norm = np.pi * self.max_r ** 2

    def integrate(self, values):
        return jnp.sum(self._w * values, axis=(-2, -1))

    def integrate_normed(self, values):
        return self.integrate(values) / self.norm

    def l2_norm(self, values):
        return self.integrate((values * jnp.conj(values)).real)


def midpoint_rule(samples, uniform_points, axis=0):
    step = uniform_points[1] - uniform_points[0]
    return step * np.sum(samples, axis=axis)


class RadialIntegrator:
    """1-D radial integrator with r^(d-1) measure (reference
    mathLibrary.py:1270-1294): trapezoidal ∫ f(r) r^{d-1} dr along `axis`,
    normalized variant divides by π(r_max^d − r_min^d)."""

    def __init__(self, rs: np.ndarray, dimension: int = 3,
                 real_dtype=jnp.float32):
        self.rs = np.asarray(rs, dtype=np.float64)
        self.dimension = int(dimension)
        self.norm = float(np.pi * self.rs.max() ** dimension
                          - np.pi * self.rs.min() ** dimension)
        w = _trapz_weights(self.rs) * self.rs ** (dimension - 1)
        np_real = np.float32 if real_dtype == jnp.float32 else np.float64
        self._w = np.asarray(w, dtype=np_real)

    def integrate(self, values, axis=-1):
        ndim = jnp.ndim(values)
        shape = [1] * ndim
        shape[axis % ndim] = len(self.rs)
        return jnp.sum(values * jnp.asarray(self._w).reshape(shape),
                       axis=axis)

    def integrate_normed(self, values, axis=-1):
        return self.integrate(values, axis=axis) / self.norm

    def l2_norm(self, values, axis=-1):
        return self.integrate((values * jnp.conj(values)).real, axis=axis)
