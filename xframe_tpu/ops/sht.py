"""Spherical harmonic transform as jit-able JAX ops.

Replacement for the reference's SHTns plugin
(/root/reference/xframe/externalLibraries/shtns_plugin.py). Design:

  forward:  FFT over φ  →  per-m associated-Legendre matmul over θ
  inverse:  per-m Legendre synthesis matmul  →  inverse FFT over φ

Coefficient layout is DENSE and PADDED: (..., n_m=2L+1, L+1) indexed
[j, l] with CENTERED m ordering (m = j - L, so j runs over m=-L..L) and
entries with l < |m| structurally zero. The valid-m block of order l is the
contiguous centered range [L-l, L+l], which keeps padded per-l matrix ops
(Procrustes unknowns, V_l projections) dense and mask-free. This rectangular
layout makes every transform a single batched matmul (einsum) that XLA hands
to the GPU's batched GEMM — no ragged per-l Python lists as in the reference
(shtns_plugin.py:105-114).

Every contraction states lax.Precision.HIGHEST: on a GPU a float32 matmul
otherwise may run in TF32 (~3 decimal digits), far outside the 1e-6
accuracy the composed transform is pinned to (tests/test_transforms.py).

Normalization: orthonormal spherical harmonics with Condon-Shortley phase
(the SHTns default used by the reference): f_lm = ∫ f Ȳ_lm dΩ,
f = Σ_lm f_lm Y_lm.  Angular grid: Gauss-Legendre in cosθ (ascending θ),
uniform φ in [0,2π).  Anti-aliasing grid rule follows shtns_plugin.py:94-101.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from xframe_tpu.library.legendre import (
    gauss_legendre,
    sph_legendre_table_full_m,
)


def angular_grid_size(l_max: int, anti_aliasing_degree: int = 2):
    """n_phi = 2^(⌊log2((N+1)·L)⌋+1), n_theta = n_phi/2  (shtns_plugin.py:94-101)."""
    n = anti_aliasing_degree
    n_phi = 2 ** (int(np.log2((n + 1) * max(l_max, 1))) + 1)
    n_phi = max(n_phi, 2 * (l_max + 1))
    n_theta = n_phi // 2
    return n_theta, n_phi


class SphericalHarmonicTransform:
    """Precomputes Legendre/quadrature tables on host; forward/inverse are pure jittable fns.

    forward(f): (..., n_theta, n_phi) complex → (..., 2L+1, L+1) coefficients [m_fft, l]
    inverse(c): (..., 2L+1, L+1) → (..., n_theta, n_phi)
    """

    def __init__(self, l_max: int, n_theta: int | None = None, n_phi: int | None = None,
                 anti_aliasing_degree: int = 2, real_dtype=jnp.float32):
        self.l_max = int(l_max)
        nt_d, np_d = angular_grid_size(self.l_max, anti_aliasing_degree)
        self.n_theta = int(n_theta) if n_theta else nt_d
        self.n_phi = int(n_phi) if n_phi else np_d
        if self.n_phi < 2 * self.l_max + 1:
            raise ValueError(
                f"n_phi={self.n_phi} cannot resolve m up to ±{self.l_max}")
        if self.n_theta < self.l_max + 1:
            raise ValueError(
                f"n_theta={self.n_theta} cannot resolve l up to {self.l_max}")
        self.n_m = 2 * self.l_max + 1
        self.real_dtype = real_dtype
        self.complex_dtype = jnp.complex64 if real_dtype == jnp.float32 else jnp.complex128

        # Gauss-Legendre nodes in cosθ; order so θ ascends (x=cosθ descends).
        x, w = gauss_legendre(self.n_theta)
        x, w = x[::-1].copy(), w[::-1].copy()
        self.cos_theta = x
        self.theta = np.arccos(x)
        self.phi = 2 * np.pi * np.arange(self.n_phi) / self.n_phi
        self.gl_weights = w

        # P̄ tables, (n_m, n_theta, L+1) in centered m-ordering (m = j - L),
        # stored as HOST numpy: jit embeds them as program constants.
        np_real = np.dtype('float32') if real_dtype == jnp.float32 else np.dtype('float64')
        P = sph_legendre_table_full_m(self.l_max, x)
        self._P = np.asarray(P, dtype=np_real)                      # synthesis
        self._PW = np.asarray(P * w[None, :, None], dtype=np_real)  # analysis (quadrature)

        ms = np.arange(-self.l_max, self.l_max + 1)
        self.m_orders = ms  # centered m values carried by the layout
        # valid-(l,m) mask: l >= |m|
        ls = np.arange(self.l_max + 1)[None, :]
        self.lm_mask = ls >= np.abs(ms)[:, None]  # (n_m, L+1), host numpy

        # Equatorial-symmetry split (the classic libsharp trick): with the GL
        # grid symmetric about θ=π/2 and P̄_lm(π-θ) = (-1)^{l+m} P̄_lm(θ), the
        # θ contraction folds to n_theta/2 points with two parity-packed
        # tables — HALF the Legendre-matmul FLOPs. Enabled for even n_theta.
        self._use_sym = self.n_theta % 2 == 0
        if self._use_sym:
            t2 = self.n_theta // 2
            L = self.l_max
            self._n_le = (L + 2) // 2             # even l count
            self._n_lo = (L + 1) // 2             # odd l count
            le = np.arange(0, L + 1, 2)
            lo = np.arange(1, L + 1, 2)
            # parity of (l+m) decides fold sign; pack by l parity, and select
            # the folded input by m parity at runtime
            self._m_even = (np.abs(ms) % 2 == 0)[:, None]  # (n_m, 1)
            self._P_e = np.ascontiguousarray(self._P[:, :t2, le])
            self._P_o = np.ascontiguousarray(self._P[:, :t2, lo])
            self._PW_e = np.ascontiguousarray(self._PW[:, :t2, le])
            self._PW_o = np.ascontiguousarray(self._PW[:, :t2, lo])

    # -- pure functions (close over host-numpy constants; safe under jit) --

    def _cx_einsum(self, spec, x, table):
        """complex field × REAL table einsum as two real-plane matmuls.

        jnp.einsum would promote the table to complex (4 real matmuls, half of
        them against a zero imaginary plane); splitting keeps it at the 2 the
        math needs."""
        hi = lax.Precision.HIGHEST
        re = jnp.einsum(spec, x.real, table, precision=hi)
        im = jnp.einsum(spec, x.imag, table, precision=hi)
        return jax.lax.complex(re, im)

    def _analysis_core(self, fm, m_rows):
        """Legendre analysis of (..., θ, m_subset) Fourier columns.

        With the equatorial split: fold θ about π/2 (sign by (l+m) parity),
        contract over n_theta/2 points with parity-packed tables — half the
        matmul FLOPs of the dense contraction."""
        if not self._use_sym:
            return self._cx_einsum('...tm,mtl->...ml', fm, self._PW[m_rows])
        t2 = self.n_theta // 2
        head = fm[..., :t2, :]
        tail = fm[..., ::-1, :][..., :t2, :]
        f_plus, f_minus = head + tail, head - tail
        m_even = self._m_even[m_rows][:, 0]
        in_e = jnp.where(m_even[None, :], f_plus, f_minus)  # (l+m) even terms
        in_o = jnp.where(m_even[None, :], f_minus, f_plus)
        c_e = self._cx_einsum('...tm,mtl->...ml', in_e, self._PW_e[m_rows])
        c_o = self._cx_einsum('...tm,mtl->...ml', in_o, self._PW_o[m_rows])
        return self._interleave_l(c_e, c_o)

    def _interleave_l(self, c_e, c_o):
        """(..., m, n_le) + (..., m, n_lo) → (..., m, L+1) with l interleaved
        even/odd — pure pad + reshape."""
        if self._n_lo < self._n_le:
            pad = jnp.zeros(c_o.shape[:-1] + (1,), dtype=c_o.dtype)
            c_o = jnp.concatenate([c_o, pad], axis=-1)
        out = jnp.stack([c_e, c_o], axis=-1).reshape(
            c_e.shape[:-1] + (2 * self._n_le,))
        return out[..., : self.l_max + 1]

    def _synthesis_core(self, c, m_rows):
        """Inverse of _analysis_core: parity-packed synthesis on the half-θ
        grid, mirrored to the full grid."""
        c = c.astype(self.complex_dtype)
        if not self._use_sym:
            return self._cx_einsum('...ml,mtl->...tm', c, self._P[m_rows])
        s_e = self._cx_einsum('...ml,mtl->...tm', c[..., 0::2], self._P_e[m_rows])
        s_o = self._cx_einsum('...ml,mtl->...tm', c[..., 1::2], self._P_o[m_rows])
        m_even = self._m_even[m_rows][:, 0]
        even_par = jnp.where(m_even[None, :], s_e, s_o)  # Σ over (l+m) even
        odd_par = jnp.where(m_even[None, :], s_o, s_e)
        head = even_par + odd_par
        tail = (even_par - odd_par)[..., ::-1, :]
        return jnp.concatenate([head, tail], axis=-2)

    def forward(self, f):
        """f(..., θ, φ) → f_lm (..., m_fft, l)."""
        fm = jnp.fft.fft(f.astype(self.complex_dtype), axis=-1)
        # centered m = -L..L from FFT bins: [-L..-1] live at the end — pure
        # slices (n_phi > 2L), no gather
        L = self.l_max
        parts = ([fm[..., -L:]] if L > 0 else []) + [fm[..., : L + 1]]
        fm = jnp.concatenate(parts, axis=-1) * (2 * np.pi / self.n_phi)
        return self._analysis_core(fm, slice(None))

    def forward_real(self, f):
        """Analysis of a REAL field: rfft + half-size Legendre contraction,
        negative m filled by the hermitian symmetry
        c_{l,-m} = (-1)^m conj(c_{l,m}). Returns the same centered layout as
        forward (used for the intensity projection in the MTIP loop)."""
        L = self.l_max
        fm = jnp.fft.rfft(f.astype(self.real_dtype), axis=-1)[..., : L + 1] \
            * (2 * np.pi / self.n_phi)
        c_pos = self._analysis_core(fm, slice(L, None))  # m = 0..L rows
        signs = ((-1.0) ** np.arange(1, L + 1))[::-1]
        c_neg = signs[:, None] * jnp.conj(c_pos[..., 1:, :])[..., ::-1, :]
        return jnp.concatenate([c_neg, c_pos], axis=-2)

    def inverse(self, c):
        """f_lm (..., m_fft, l) → f(..., θ, φ)."""
        fm = self._synthesis_core(c, slice(None))
        # scatter centered m back to FFT bins with zero padding in between —
        # slice + concat instead of a scatter
        L = self.l_max
        pad = self.n_phi - self.n_m
        zeros = jnp.zeros(fm.shape[:-1] + (pad,), dtype=fm.dtype)
        full = jnp.concatenate([fm[..., L:], zeros, fm[..., :L]], axis=-1)
        return jnp.fft.ifft(full, axis=-1) * self.n_phi

    def inverse_real(self, c):
        """Real part of the synthesis, computed via a hermitian fold + irfft:
        Re(Σ_m f_m e^{imφ}) ≡ irfft of the hermitian-averaged half-spectrum —
        identical to `inverse(c).real` at half the inverse-FFT cost (used for
        the projected intensity in the MTIP loop)."""
        fm = self._synthesis_core(c, slice(None))
        L = self.l_max
        pos = fm[..., L:]                             # m = 0..L
        neg = fm[..., :L][..., ::-1]                  # m = -1..-L
        half = 0.5 * (pos.at[..., 1:].add(jnp.conj(neg)))
        half = half.at[..., 0].set(pos[..., 0].real + 0j)
        n_half = self.n_phi // 2 + 1
        padw = n_half - (L + 1)
        zeros = jnp.zeros(half.shape[:-1] + (padw,), dtype=half.dtype)
        spec = jnp.concatenate([half, zeros], axis=-1)
        return jnp.fft.irfft(spec * self.n_phi, self.n_phi, axis=-1)


class CircularHarmonicTransform:
    """2D circular harmonic transform (reference mathLibrary.py:469-496).

    forward: f(..., φ) → f_m = FFT(f)/n_phi   (full FFT ordering, n_m = n_phi)
    inverse: f_m → f = IFFT(f_m · n_phi)
    """

    def __init__(self, n_phi: int, real_dtype=jnp.float32):
        self.n_phi = int(n_phi)
        self.complex_dtype = jnp.complex64 if real_dtype == jnp.float32 else jnp.complex128

    def forward(self, f):
        return jnp.fft.fft(f.astype(self.complex_dtype), axis=-1) / self.n_phi

    def inverse(self, c):
        return jnp.fft.ifft(c.astype(self.complex_dtype) * self.n_phi, axis=-1)

    # real fast paths (mathLibrary.py:484-496): rfft halves the transform for
    # real-valued rings; coefficients keep the same 1/n_phi normalization
    def forward_real(self, f):
        return jnp.fft.rfft(f.real, axis=-1) / self.n_phi

    def inverse_real(self, c):
        return jnp.fft.irfft(c.astype(self.complex_dtype) * self.n_phi,
                             n=self.n_phi, axis=-1)
