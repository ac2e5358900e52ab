"""Host-side special-function tables (float64, numpy/scipy).

Replaces the reference's pygsl plugin (/root/reference/xframe/externalLibraries/
gsl_plugin.py:8-91): orthonormalized associated Legendre values, spherical
Bessel tables, and Gauss-Legendre nodes. Everything here runs once at setup
time on the host in float64; the resulting tables are shipped to the device as
constants of the jitted transforms.
"""
from __future__ import annotations

import numpy as np
from scipy.special import roots_legendre


def gauss_legendre(n, start=-1.0, stop=1.0):
    """Gauss-Legendre nodes/weights on [start, stop] (reference mathLibrary.py:526-533)."""
    xi, w = roots_legendre(n)
    xi = (stop - start) / 2 * xi + (start + stop) / 2
    w = (stop - start) / 2 * w
    return xi, w


def sph_legendre_table(l_max: int, x: np.ndarray) -> np.ndarray:
    """Orthonormalized (4π) associated Legendre values P̄_l^m(x) for 0<=m<=l<=l_max.

    P̄_l^m(x) = sqrt((2l+1)/(4π) * (l-m)!/(l+m)!) * P_l^m(x), with the
    Condon-Shortley phase included in P_l^m (same convention as GSL's
    legendre_sphPlm used by the reference, gsl_plugin.py:8-69).

    Returns array of shape (len(x), l_max+1, l_max+1) indexed [x, m, l];
    entries with l < m are zero.

    Uses the standard stable three-term recurrence in l at fixed m, with the
    diagonal seeded by the m-recurrence — accurate to ~1e-14 for l_max ≲ 2000.
    """
    x = np.asarray(x, dtype=np.float64)
    nx = x.shape[0]
    L = l_max
    out = np.zeros((nx, L + 1, L + 1), dtype=np.float64)
    sx = np.sqrt(np.maximum(0.0, 1.0 - x * x))  # sin(theta)

    # diagonal: P̄_m^m
    pmm = np.full(nx, np.sqrt(1.0 / (4.0 * np.pi)))
    out[:, 0, 0] = pmm
    for m in range(1, L + 1):
        pmm = -np.sqrt((2 * m + 1) / (2.0 * m)) * sx * pmm
        out[:, m, m] = pmm
    # off-diagonal upward recurrence in l
    for m in range(0, L + 1):
        if m + 1 <= L:
            out[:, m, m + 1] = x * np.sqrt(2 * m + 3.0) * out[:, m, m]
        for l in range(m + 2, L + 1):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            out[:, m, l] = a * (x * out[:, m, l - 1] - b * out[:, m, l - 2])
    return out


def sph_legendre_table_full_m(l_max: int, x: np.ndarray) -> np.ndarray:
    """P̄_l^m for all m in CENTERED ordering: index j ∈ [0, 2L] ↔ m = j - L.

    Returns (n_m=2L+1, len(x), L+1) indexed [j, x, l]. The centered layout
    makes the valid-m block of each order l the contiguous range [L-l, L+l] —
    the key property that keeps padded per-l matrix ops (Procrustes unknowns,
    V_l projections) dense and mask-free.
    Negative orders via P̄_l^{-m} = (-1)^m P̄_l^m (orthonormal + CS phase).
    """
    t = sph_legendre_table(l_max, x)  # (nx, m, l)
    L = l_max
    pos = np.moveaxis(t, 0, 1)  # (m, nx, l)
    n_m = 2 * L + 1
    out = np.zeros((n_m, x.shape[0], L + 1), dtype=np.float64)
    out[L:] = pos
    signs = (-1.0) ** np.arange(1, L + 1)
    # j = 0..L-1 correspond to m = -L..-1
    out[:L] = (signs[::-1, None, None]) * pos[1:][::-1]
    return out


def legendre_poly_table(l_max: int, x: np.ndarray) -> np.ndarray:
    """Plain Legendre polynomials P_l(x), shape (len(x), l_max+1).

    The recurrence runs with l as the LEADING axis so every update touches
    contiguous memory (the l-last layout was ~15× slower on big inputs from
    stride-(L+1) writes), then one transpose-copy at the end."""
    x = np.asarray(x, dtype=np.float64)
    tmp = np.empty((l_max + 1,) + x.shape, dtype=np.float64)
    tmp[0] = 1.0
    if l_max >= 1:
        tmp[1] = x
    for l in range(2, l_max + 1):
        np.multiply(x, tmp[l - 1], out=tmp[l])
        tmp[l] *= (2 * l - 1) / l
        tmp[l] -= (l - 1) / l * tmp[l - 2]
    return np.ascontiguousarray(np.moveaxis(tmp, 0, -1))


def centered_m_orders(l_max: int) -> np.ndarray:
    """Harmonic orders in centered layout: [-L, .., -1, 0, 1, .., L]."""
    return np.arange(-l_max, l_max + 1)
