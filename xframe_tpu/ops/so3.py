"""SO(3) rotations and cross-correlation of spherical-harmonic expansions.

Replacement for the reference's pysofft plugin
(/root/reference/xframe/externalLibraries/soft_plugin.py): Wigner-d matrices
are built once on the host by eigendecomposition of J_y (exact, stable to high
l — no factorial overflow), and both coefficient rotation and the SO(3)
cross-correlation become batched einsums + a 2D FFT, all jittable:

  C(α,β,γ) = Σ_{l,m,m'} f^l_m  g^{l*}_{m'}  e^{-imα} d^l_{mm'}(β) e^{-im'γ}

evaluated as: M^l_{mm'} = Σ_r w_r f^l_m(r) g^{l*}_{m'}(r)  (radial average),
T_b = Σ_l d^l(β_b)·M^l  (per-β matmul-like contraction),
C = FFT_2D over (m, m').

Coefficient layout matches ops.sht: (..., n_m = 2L+1, L+1), centered m.
Contractions run at lax.Precision.HIGHEST (no TF32 on a GPU).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

_HI = lax.Precision.HIGHEST


# ----------------------------------------------------------- Wigner-d (host)
def _jy_matrix(l: int) -> np.ndarray:
    """⟨m'|J_y|m⟩ for spin l, (2l+1)² Hermitian; basis m = -l..l."""
    ms = np.arange(-l, l + 1)
    cp = np.sqrt(l * (l + 1) - ms * (ms + 1))  # J+ |m> -> |m+1>
    J = np.zeros((2 * l + 1, 2 * l + 1), dtype=complex)
    for i, m in enumerate(ms[:-1]):
        J[i + 1, i] = cp[i] / 2j * (-1)   # -i/2 * c+  at (m+1, m)
        J[i, i + 1] = np.conj(J[i + 1, i])
    return J


def wigner_d_blocks(l_max: int, betas: np.ndarray) -> list:
    """[d^l(β)] for l = 0..L; each (n_beta, 2l+1, 2l+1) real float64.

    d^l(β) = exp(+iβ J_y) via eigendecomposition of J_y (exact integer
    spectrum -l..l). Sign fixed so that D^l_{mm'}(α,β,γ) = e^{-imα} d e^{-im'γ}
    implements (Λ(R)f)(x) = f(R⁻¹x) with R = Rz(α)Ry(β)Rz(γ) in the
    orthonormal Condon-Shortley basis of ops.sht (verified in
    tests/test_so3.py::test_rotation_matches_grid_rotation)."""
    betas = np.atleast_1d(np.asarray(betas, dtype=float))
    out = []
    for l in range(l_max + 1):
        lam, V = np.linalg.eigh(_jy_matrix(l))
        phase = np.exp(1j * betas[:, None] * lam[None, :])
        d = np.einsum("mk,bk,nk->bmn", V, phase, V.conj())
        out.append(d.real)
    return out


def wigner_d_padded(l_max: int, betas: np.ndarray) -> np.ndarray:
    """Dense padded table (n_beta, L+1, n_m, n_m), centered-m window per l."""
    blocks = wigner_d_blocks(l_max, betas)
    n_beta = blocks[0].shape[0]
    n_m = 2 * l_max + 1
    table = np.zeros((n_beta, l_max + 1, n_m, n_m))
    for l, d in enumerate(blocks):
        s = slice(l_max - l, l_max + l + 1)
        table[:, l, s, s] = d
    return table


def wigner_D_single(l_max: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Padded D^l_{m m'}(α,β,γ) = e^{-imα} d^l_{mm'}(β) e^{-im'γ},
    (L+1, n_m, n_m) complex."""
    d = wigner_d_padded(l_max, [beta])[0]
    ms = np.arange(-l_max, l_max + 1)
    return (np.exp(-1j * ms * alpha)[None, :, None] * d
            * np.exp(-1j * ms * gamma)[None, None, :])


def rotate_coeff(coeff, D):
    """(Λ(R)f)^l_m = Σ_{m'} D^l_{m m'} f^l_{m'};  coeff (..., n_m, L+1)."""
    return jnp.einsum("lmn,...nl->...ml", jnp.asarray(D, dtype=coeff.dtype),
                      coeff, precision=_HI)


# ------------------------------------------------------------ SO(3) correlator
def so3_grid(bandwidth: int):
    """SOFT-style sampling: α,γ uniform on [0,2π) with 2B points,
    β_j = π(2j+1)/(4B) (soft_plugin.py grid convention)."""
    B = int(bandwidth)
    alphas = 2 * np.pi * np.arange(2 * B) / (2 * B)
    betas = np.pi * (2 * np.arange(2 * B) + 1) / (4 * B)
    gammas = alphas.copy()
    return alphas, betas, gammas


class SO3Correlator:
    """Correlation of two SH-expanded signals over the full rotation group.

    l_max: harmonic band limit; n_alpha controls the (α,γ) FFT grid
    (default 2(l_max+1)). The padded Wigner table is float32 on device —
    (n_beta, L+1, n_m, n_m)."""

    def __init__(self, l_max: int, bandwidth: int = None, real_dtype=jnp.float32):
        self.l_max = int(l_max)
        B = int(bandwidth) if bandwidth else self.l_max + 1
        self.bandwidth = B
        self.alphas, self.betas, self.gammas = so3_grid(B)
        self.n_ab = 2 * B
        np_real = np.float32 if real_dtype == jnp.float32 else np.float64
        table = wigner_d_padded(self.l_max, self.betas)
        self._d = np.asarray(table, dtype=np_real)   # (n_beta, L+1, n_m, n_m), host
        ms = np.arange(-self.l_max, self.l_max + 1)
        self._m_cols = ms % self.n_ab
        self.cdtype = jnp.complex64 if real_dtype == jnp.float32 else jnp.complex128

    def correlate(self, f_coeff, g_coeff, radial_weights=None):
        """C(α,β,γ) real, shape (2B, 2B, 2B) with axes (α, β, γ).

        f_coeff/g_coeff: (n_r, n_m, L+1) or (n_m, L+1)."""
        f = jnp.asarray(f_coeff, dtype=self.cdtype)
        g = jnp.asarray(g_coeff, dtype=self.cdtype)
        if f.ndim == 2:
            f, g = f[None], g[None]
        if radial_weights is None:
            M = jnp.einsum("rml,rnl->lmn", f, g.conj(), precision=_HI)
        else:
            w = jnp.asarray(radial_weights, dtype=self._d.dtype)
            M = jnp.einsum("r,rml,rnl->lmn", w, f, g.conj(), precision=_HI)
        T = jnp.einsum("blmn,lmn->bmn", self._d.astype(self.cdtype), M,
                       precision=_HI)
        # C(α,β,γ) = Re Σ_{mm'} T_β[m,m'] e^{+imα} e^{+im'γ}  — the +i phases
        # make argmax(C) the rotation with rotate_coeff(g, D(α̂,β̂,γ̂)) ≈ f
        # (C = Re⟨Λ(R)g, f⟩; verified in tests/test_so3.py). Embed centered
        # (m, m') into FFT bins and evaluate both sums with one ifft2.
        full = jnp.zeros((T.shape[0], self.n_ab, self.n_ab), dtype=self.cdtype)
        full = full.at[:, self._m_cols[:, None], self._m_cols[None, :]].set(T)
        C = jnp.fft.ifft2(full, axes=(1, 2)) * self.n_ab ** 2
        return jnp.moveaxis(C.real, 0, 1)  # (α, β, γ)

    def argmax_euler(self, C):
        """Euler angles (α,β,γ) of the correlation maximum (zyz convention)."""
        idx = jnp.unravel_index(jnp.argmax(C), C.shape)
        return (jnp.asarray(self.alphas)[idx[0]],
                jnp.asarray(self.betas)[idx[1]],
                jnp.asarray(self.gammas)[idx[2]])
