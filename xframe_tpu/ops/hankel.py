"""Radial (spherical/polar) Hankel transforms as batched per-order matmuls.

Replacement for the reference's OpenCL `apply_weights` kernels and
CPU einsum loops (/root/reference/xframe/projects/fxs/projectLibrary/
hankel_transforms.py). Weight tables are computed once on the host in float64
(scipy Bessel functions — replacing the reference's per-order multiprocessing
fan-out, hankel_transforms.py:78-80) and shipped to the device; the transform
itself is a single einsum `out[p,m,l] = Σ_k W[k,p,l]·f[k,m,l]` — a batch of
L+1 dense (N×N)@(N×n_m) matmuls that XLA hands to the batched GEMM, at
lax.Precision.HIGHEST (a float32 GPU matmul may otherwise run in TF32).

Quadrature modes (formulas match hankel_transforms.py:302-535):
  midpoint : r_p=(p+½)Δr, all samples used                    [tutorial default]
  trapz    : r_p=pΔr, input sample at r=0 skipped
  gauss    : Gauss-Legendre nodes on [0,r_max]
  zernike  : Zernike-expansion variant of trapz/midpoint

Forward 3D:  F_l(q_p) = (-i)^l √(2/π) Σ_k w_{kp}^l f_l(r_k),
with w including r² and the quadrature weight; inverse uses (+i)^l and the
q-grid constants. 2D uses (-i)^m (no √(2/π)) and w_{-m} = (-1)^m w_m.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax
from scipy.special import jv, eval_jacobi

from xframe_tpu.library.legendre import gauss_legendre

HT_MODES = ('trapz', 'Zernike', 'midpoint', 'gauss')


def spherical_jn_all(l_max: int, z: np.ndarray) -> np.ndarray:
    """j_l(z) for every l = 0..l_max at once, vectorized over z (float64).

    scipy's `spherical_jn` ufunc re-runs its internal recurrence for every
    (l, z) pair — O(l_max²·n_z); at the simulation worker's N=512, L=128
    weight table that alone is ~80 s of host time (the cold-start hog,
    docs/performance.md). One recurrence shared by all orders is
    O(l_max·n_z): upward j_{l+1} = (2l+1)/z·j_l − j_{l-1} where it is
    stable (z > l for every needed l), Miller's downward recurrence for the
    remaining small-z points (seed above l_max, recur down, normalize
    against j_0 = sin z / z — or j_1 near a zero of j_0), rescaling the
    already-stored tail whenever the unnormalized values approach overflow
    at tiny z. → shape (l_max+1,) + z.shape."""
    z = np.asarray(z, dtype=np.float64)
    zf = z.ravel()
    out = np.empty((l_max + 1, zf.size), dtype=np.float64)
    up = zf > l_max + 12
    dn = ~up

    zu = zf[up]
    if zu.size:
        jm1 = np.sin(zu) / zu
        out[0, up] = jm1
        if l_max >= 1:
            jl = jm1 / zu - np.cos(zu) / zu
            out[1, up] = jl
            for l in range(1, l_max):
                jm1, jl = jl, (2 * l + 1) / zu * jl - jm1
                out[l + 1, up] = jl

    zd = zf[dn]
    if zd.size:
        zero = zd == 0.0
        zs = np.where(zero, 1.0, zd)
        # start offset: ~c·z^(1/3) covers the turning-point region; z here
        # is at most l_max+12 so a flat sqrt-based margin is generous
        l_start = l_max + 16 + int(np.ceil(np.sqrt(40.0 * (l_max + 1))))
        sub = np.zeros((l_max + 1, zd.size))
        jp1 = np.zeros(zd.size)
        jl = np.full(zd.size, 1e-30)
        for l in range(l_start, 0, -1):
            if l <= l_max:
                sub[l] = jl
            jp1, jl = jl, (2 * l + 1) / zs * jl - jp1
            big = np.abs(jl) > 1e250
            if big.any():
                jl[big] *= 1e-250
                jp1[big] *= 1e-250
                sub[:, big] *= 1e-250
        sub[0] = jl
        j0 = np.where(zero, 1.0, np.sin(zs) / zs)
        if l_max >= 1:
            j1 = j0 / zs - np.cos(zs) / zs
            pick1 = np.abs(sub[1]) > np.abs(sub[0])
            denom = np.where(pick1, sub[1], sub[0])
            numer = np.where(pick1, j1, j0)
        else:
            denom, numer = sub[0], j0
        sub *= numer / np.where(denom == 0.0, 1.0, denom)
        if zero.any():
            sub[:, zero] = 0.0
            sub[0, zero] = 1.0
        out[:, dn] = sub

    return out.reshape((l_max + 1,) + z.shape)


def zernike_radial(l: int, s_values: np.ndarray, x: np.ndarray,
                   dimension: int) -> np.ndarray:
    """Radial part R^l_s(x) of D-dimensional Zernike polynomials
    (reference mathLibrary.py eval_ND_zernike_polynomials :805-820):
    R^l_s(x) = (-1)^((s-l)/2) x^l P^{(l+D/2-1, 0)}_{(s-l)/2}(1-2x²).
    → (len(s_values), len(x))."""
    k = ((np.asarray(s_values) - l) // 2).astype(int)
    sign = (-1.0) ** k
    return sign[:, None] * x[None, :] ** l \
        * eval_jacobi(k[:, None], l + dimension / 2 - 1, 0,
                      1 - 2 * x[None, :] ** 2)


def reciprocity_relation(cutoff: float, n_points: int, reciprocity_coefficient: float = np.pi):
    """Q·R = c·N  (reference mathLibrary.py:1169-1177)."""
    return reciprocity_coefficient * n_points / cutoff


# ---------------------------------------------------------------- radial grids
def radial_grids(mode: str, q_max: float, n_points: int, reciprocity_coefficient: float):
    """Real/reciprocal radial sampling points for a quadrature mode
    (reference ft_grid_pairs.py:274-300)."""
    N = n_points
    r_max = reciprocity_relation(q_max, N, reciprocity_coefficient)
    if mode in ('trapz', 'Zernike'):
        # r_p = p·r_max/N: the sampling the quadrature weights assume
        # (j_l(q_k r_p) = j_l(k·p·x/N) requires q_k r_p = kp·x/N)
        rs = np.arange(N) * r_max / N
        qs = np.arange(N) * q_max / N
    elif mode == 'midpoint':
        dr, dq = r_max / N, q_max / N
        rs = np.linspace(dr / 2, r_max - dr / 2, N)
        qs = np.linspace(dq / 2, q_max - dq / 2, N)
    elif mode == 'gauss':
        x, _ = gauss_legendre(N)
        rs = r_max / 2 * x + r_max / 2
        qs = q_max / 2 * x + q_max / 2
    else:
        raise ValueError(f"unknown Hankel mode {mode!r}; known: {HT_MODES}")
    return rs, qs, r_max


# ------------------------------------------------------------- raw weights (host)
def _spherical_weights(mode, l_max, N, rc):
    if mode == 'midpoint':
        ps = np.arange(N) + 0.5
        ks = np.arange(N) + 0.5
        arg = ks[None, :] * ps[:, None] * rc / N          # (p,k)
        j = spherical_jn_all(l_max, arg)                   # (l,p,k)
        return ps[None, :, None] ** 2 * j, None
    if mode == 'trapz':
        ps = np.arange(1, N)
        ks = np.arange(N)
        arg = ks[None, :] * ps[:, None] * rc / N
        j = spherical_jn_all(l_max, arg)
        return ps[None, :, None] ** 2 * j, None
    if mode == 'Zernike':
        return _zernike_weights(l_max, N, rc, dimensions=3), None
    if mode == 'gauss':
        x, wg = gauss_legendre(N)
        ps = x + 1
        arg = ps[None, :] * ps[:, None] * rc * N / 4
        j = spherical_jn_all(l_max, arg)
        return ps[None, :, None] ** 2 * j * wg[None, :, None], None
    raise ValueError(mode)


def _zernike_weights(max_order, N, rc, dimensions, expansion_limit=None):
    """Zernike-expansion quadrature weights (reference
    hankel_transforms.py:52-180, trapz variant): the radial profile is
    expanded in D-dim Zernike polynomials R^l_s, whose Hankel transforms are
    Bessel functions j_{s+1}/J_{s+1} — giving weights

      w_l[p,k] = c[p,k] Σ_{s=l,l+2..S} (-1)^((s-l)/2)(2s+D) R^l_s(p/N) B_{s+1}(k·x)

    with B = spherical j (3D, c=p²/k) or J (2D, c=p/k); the r=0 input sample
    is dropped (sum axis length N-1)."""
    if expansion_limit is None:
        expansion_limit = 2 * (2 * N - 1)
    expansion_limit = max(expansion_limit, max_order)
    ps = np.arange(1, N)
    ks = np.arange(N)
    out = np.zeros((max_order + 1, N - 1, N))
    j_all = (spherical_jn_all(expansion_limit + 1, ks[1:] * rc)
             if dimensions == 3 else None)
    for l in range(max_order + 1):
        s = np.arange(l, expansion_limit + 1, 2)
        if dimensions == 3:
            pref = (-1.0) ** ((s - l) / 2) * (2 * s + 3)
            B = j_all[s + 1]
        else:
            pref = (-1.0) ** ((s - l) / 2) * (2 * s + 2)
            B = jv((s + 1)[:, None], ks[1:][None, :] * rc)
        Z = zernike_radial(l, s, ps / N, dimensions)       # (len_s, n_p)
        w = np.zeros((N - 1, N))
        w[:, 1:] = np.einsum("s,sp,sk->pk", pref, Z, B)
        if l == 0:
            w[:, 0] = rc  # s=0, k=0 Bessel limit (reference :121)
        out[l] = w
    c = np.zeros((N - 1, N))
    if dimensions == 3:
        c[:, 1:] = (ps ** 2)[:, None] / ks[None, 1:]
        c[:, 0] = ps ** 2
    else:
        c[:, 1:] = ps[:, None] / ks[None, 1:]
        c[:, 0] = ps
    return out * c[None]


def _polar_weights(mode, m_max, N, rc):
    ms = np.arange(m_max + 1)
    if mode == 'midpoint':
        ps = np.arange(N) + 0.5
        arg = ps[None, :] * ps[:, None] * rc / N
        J = jv(ms[:, None, None], arg[None])
        return ps[None, :, None] * J
    if mode == 'trapz':
        ps = np.arange(1, N)
        ks = np.arange(N)
        arg = ks[None, :] * ps[:, None] * rc / N
        J = jv(ms[:, None, None], arg[None])
        return ps[None, :, None] * J
    if mode == 'Zernike':
        return _zernike_weights(m_max, N, rc, dimensions=2)
    if mode == 'gauss':
        x, wg = gauss_legendre(N)
        ps = x + 1
        arg = ps[None, :] * ps[:, None] * rc * N / 4
        J = jv(ms[:, None, None], arg[None])
        return ps[None, :, None] * J * wg[None, :, None]
    raise ValueError(mode)


def generate_weights(max_order: int, n_radial_points: int,
                     reciprocity_coefficient: float = np.pi,
                     dimensions: int = 3, mode: str = 'midpoint'):
    """Raw quadrature weight tables (order, p_sum, k_out), float64.

    Mirrors hankel_transforms.generate_weightDict (reference :22-48) so the
    same disk-cache key (N, max_order, reciprocity coefficient, mode) applies.
    """
    if dimensions == 3:
        w, _ = _spherical_weights(mode, max_order, n_radial_points, reciprocity_coefficient)
    elif dimensions == 2:
        w = _polar_weights(mode, max_order, n_radial_points, reciprocity_coefficient)
    else:
        raise ValueError(f"dimensions must be 2 or 3, got {dimensions}")
    return {'weights': w, 'posHarmOrders': np.arange(max_order + 1), 'mode': mode,
            'dimension': dimensions}


def assemble_weights(weights: np.ndarray, r_max: float,
                     reciprocity_coefficient: float, dimensions: int,
                     mode: str, dtype=np.complex128):
    """Apply forward/inverse prefactors; reorder to (k_sum, p_out, order).

    Matches assemble_weights_* (hankel_transforms.py:349-535): 3D prefactors
    (∓i)^l·c_fwd/inv·√(2/π); 2D extends to negative m via w_{-m}=(-1)^m w_m.
    `dtype`: target complex dtype of the tables. Passing complex64 builds
    the f32 tables directly — at simulation grids the raw weights are a
    270 MB f64 cube, and the complex128-then-cast route costs ~20 s of
    host time and >1 GB of transient allocation per transform."""
    rdtype = np.float32 if np.dtype(dtype) == np.complex64 else np.float64
    weights = np.asarray(weights, dtype=rdtype)
    n_radial_points = weights.shape[-1]
    q_max = reciprocity_relation(r_max, n_radial_points, reciprocity_coefficient)
    if mode == 'gauss':
        c_fwd, c_inv = (r_max / 2), (q_max / 2)
    else:
        c_fwd, c_inv = (r_max / n_radial_points), (q_max / n_radial_points)

    # Zernike weights absorb an extra 1/π per angular dimension
    # (assemble_weights_zernike, reference hankel_transforms.py:272-287)
    extra = {'Zernike': {3: 1 / np.pi, 2: 1 / np.pi}}.get(mode, {}).get(dimensions, 1.0)
    if dimensions == 3:
        orders = np.arange(weights.shape[0])
        fwd_pref = (-1j) ** orders * c_fwd ** 3 * np.sqrt(2 / np.pi) * extra
        inv_pref = (1j) ** orders * c_inv ** 3 * np.sqrt(2 / np.pi) * extra
    else:
        pos = np.arange(weights.shape[0])
        all_orders = np.concatenate((pos, -pos[:0:-1]))
        fwd_pref = (-1j) ** all_orders * c_fwd ** 2 * extra
        inv_pref = (1j) ** all_orders * c_inv ** 2 * extra
        weights = np.concatenate(
            (weights, (-1.0) ** pos[:0:-1, None, None] * weights[:0:-1]), axis=0)

    w = np.moveaxis(weights, 0, 2)  # (p_sum, k_out, order)
    return {'forward': w * fwd_pref[None, None, :].astype(dtype),
            'inverse': w * inv_pref[None, None, :].astype(dtype),
            'mode': mode}


# ------------------------------------------------------------------ device apply
class SphericalHankelTransform:
    """forward(f): (..., n_r, n_m, L+1) harmonic coefficients in r
                →  (..., n_r, n_m, L+1) in q.   inverse analogous.

    For trapz/Zernike modes the r=0 input sample is dropped from the sum
    (hankel_transforms.py:649-652)."""

    def __init__(self, weights_dict: dict, r_max: float,
                 reciprocity_coefficient: float = np.pi, real_dtype=jnp.float32):
        mode = weights_dict['mode']
        cdtype = np.complex64 if real_dtype == jnp.float32 else np.complex128
        w = assemble_weights(np.asarray(weights_dict['weights']), r_max,
                             reciprocity_coefficient, 3, mode, dtype=cdtype)
        self.mode = mode
        self.skip_zero = mode in ('trapz', 'Zernike')
        # host numpy: embedded as jit constants without device readback
        self._wf = np.asarray(w['forward'], dtype=cdtype)   # (k_sum, p_out, L+1)
        self._wi = np.asarray(w['inverse'], dtype=cdtype)
        self.n_radial_points = self._wf.shape[1]

    def _apply(self, w, f):
        if self.skip_zero:
            f = f[..., 1:, :, :]
        return jnp.einsum('kpl,...kml->...pml', w, f,
                          precision=lax.Precision.HIGHEST)

    def forward(self, f):
        return self._apply(self._wf, f)

    def inverse(self, f):
        return self._apply(self._wi, f)


class PolarHankelTransform:
    """2D variant on full-FFT m layout: f (..., n_r, n_m_used) with columns in
    FFT order [0..M, -M..-1]."""

    def __init__(self, weights_dict: dict, r_max: float,
                 reciprocity_coefficient: float = np.pi, real_dtype=jnp.float32):
        mode = weights_dict['mode']
        cdtype = np.complex64 if real_dtype == jnp.float32 else np.complex128
        w = assemble_weights(np.asarray(weights_dict['weights']), r_max,
                             reciprocity_coefficient, 2, mode, dtype=cdtype)
        self.mode = mode
        self.skip_zero = mode in ('trapz', 'Zernike')
        self._wf = np.asarray(w['forward'], dtype=cdtype)   # (k_sum, p_out, n_m)
        self._wi = np.asarray(w['inverse'], dtype=cdtype)
        self.n_m = self._wf.shape[-1]

    def _apply(self, w, f):
        if self.skip_zero:
            f = f[..., 1:, :]
        return jnp.einsum('kpm,...km->...pm', w, f,
                          precision=lax.Precision.HIGHEST)

    def forward(self, f):
        return self._apply(self._wf, f)

    def inverse(self, f):
        return self._apply(self._wi, f)


# --------------------------------------------------- large-table argument path
def weight_planes(ht):
    """(forward, inverse) float32 real/imag planes of a Hankel transform's
    tables — for passing weights as jit ARGUMENTS instead of embedded
    constants, which is wise beyond ~100 MB of tables."""
    return ((np.ascontiguousarray(ht._wf.real, dtype=np.float32),
             np.ascontiguousarray(ht._wf.imag, dtype=np.float32)),
            (np.ascontiguousarray(ht._wi.real, dtype=np.float32),
             np.ascontiguousarray(ht._wi.imag, dtype=np.float32)))


def apply_hankel_planes(w_re, w_im, f, skip_zero=False):
    """Jittable Hankel application with the weight planes as traced inputs:
    out[..., p, m, l] = Σ_k (w_re+i·w_im)[k,p,l] · f[..., k, m, l]."""
    if skip_zero:
        f = f[..., 1:, :, :]
    w = (w_re + 1j * w_im).astype(f.dtype)
    return jnp.einsum('kpl,...kml->...pml', w, f,
                      precision=lax.Precision.HIGHEST)
