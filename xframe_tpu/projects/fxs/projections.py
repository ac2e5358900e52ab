"""MTIP projection operators as pure jittable JAX functions.

Rebuilt from /root/reference/xframe/projects/fxs/projectLibrary/
fxs_Projections.py. All per-l ragged structures of the reference (lists of
(n_q, 2l+1) matrices) become dense padded tensors in the centered-m layout of
ops.sht, so the reciprocal (MTIP) projection is three batched matmuls plus one
batched polar/SVD factorization — no Python loops over orders.

Conventions preserved from the reference:
  * projection data V_l arrives "schmidt-style" and is scaled ×2 internally;
    l=0 is replaced by averaged_intensity·2√π when use_averaged_intensity
    (fxs_Projections.py:706-713)
  * unknown unitaries U_l solve the per-l orthogonal Procrustes problem
    min‖I_l − V_l U_l‖ via svd(V_l† D² I_l)  (fxs_Projections.py:752-790)
  * amplitude projection ψ ← ψ·√(I_new/|ψ|²)  (fxs_Projections.py:874-929)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

# Every contraction of the data projection states its precision: a float32
# matmul on a GPU may otherwise run in TF32 (~3 decimal digits), which would
# break the Newton–Schulz unitarity target (ops.polar_schedule).
_HI = lax.Precision.HIGHEST


def _mm(spec, a, b):
    return jnp.einsum(spec, a, b, precision=_HI)


def polar_unitary_newton_schulz(M, iterations=18, eps=1e-12, order=5,
                                schedule=None):
    """Unitary polar factor of a (batched) matrix via Newton–Schulz-type
    matmul-only iterations — unlike jnp.linalg.svd this is nothing but
    batched GEMMs, which keeps the per-iteration Procrustes step cheap.

    order=3: X ← 1.5X − 0.5·X(X†X), σ growth 1.5×/step.
    order=5 (default): X ← aX + bX(X†X) + cX(X†X)², with the odd-polynomial
    coefficients (3.4445, −4.7750, 2.0315) tuned for aggressive small-σ
    growth (~3.4×/step; the scheme popularized by Muon-style orthogonalizers)
    followed by two cubic polishing steps — ill-conditioned inputs converge
    in ~⅓ the steps of the cubic iteration.

    schedule: optional tuple of per-step (a, b, c) quintic coefficients
    (ops.polar_schedule.polar_express_schedule) — the interval-optimal
    minimax composition; replaces `iterations`+polish entirely (14 steps
    instead of 16+4 at the same pinned accuracy — 42 vs 56 matmul-units,
    a 1.33× cut of the MTIP iteration's largest FLOP block at production
    scale)."""
    # spectral-norm upper bound √(‖M‖₁·‖M‖∞) — much tighter than Frobenius,
    # which matters for the small-σ convergence phase
    a = jnp.abs(M)
    norm = jnp.sqrt(jnp.max(jnp.sum(a, axis=-1), axis=-1)
                    * jnp.max(jnp.sum(a, axis=-2), axis=-1))[..., None, None]
    X = M / (norm + eps)

    def cubic(X, _):
        XhX = _mm("...ij,...ik->...jk", X.conj(), X)
        return 1.5 * X - 0.5 * _mm("...ij,...jk->...ik", X, XhX), None

    if schedule is not None:
        coeffs = jnp.asarray(np.asarray(schedule, dtype=np.float32))

        def sched_step(X, abc):
            a, b, c = abc[0], abc[1], abc[2]
            A = _mm("...ij,...ik->...jk", X.conj(), X)
            B = (b.astype(X.dtype) * A
                 + c.astype(X.dtype) * _mm("...ij,...jk->...ik", A, A))
            return (a.astype(X.dtype) * X
                    + _mm("...ij,...jk->...ik", X, B)), None

        X, _ = jax.lax.scan(sched_step, X, coeffs)
        return X

    if order == 3:
        X, _ = jax.lax.scan(cubic, X, None, length=iterations)
        return X

    ca, cb, cc = 3.4445, -4.7750, 2.0315

    def quintic(X, _):
        A = _mm("...ij,...ik->...jk", X.conj(), X)      # X†X
        B = cb * A + cc * _mm("...ij,...jk->...ik", A, A)
        return ca * X + _mm("...ij,...jk->...ik", X, B), None

    X, _ = jax.lax.scan(quintic, X, None, length=iterations)
    # polish: the quintic coefficients leave σ oscillating in a ±0.3 band
    # around 1; four cubic steps contract that quadratically (→ ~1e-6)
    X, _ = jax.lax.scan(cubic, X, None, length=4)
    return X


# ------------------------------------------------------------ reciprocal side
@dataclass
class ReciprocalConstraint:
    """Device-resident constants of the reciprocal (data) projection."""
    V_pad: Any          # (L+1, n_q, n_m) padded projection matrices (centered window)
    PD: Any             # (L+1, n_m, n_q) = V_pad† D²
    eye_diag: Any       # (L+1, n_m) real diagonal of the identity on indices
    #                       outside the l-window (materialized in-trace: the
    #                       dense (L+1, n_m, n_m) form is a 68 MB jit constant
    #                       at production scale)
    use_order: Any      # (L+1,) bool
    radial_mask: Any    # (L+1, n_q) bool
    n_particles: float
    l_max: int
    procrustes_method: str = "svd"   # 'svd' | 'newton_schulz'
    ns_iterations: int = 16
    # optional minimax per-step quintic coefficients (ops.polar_schedule);
    # when set they replace the fixed 16+4 iteration in BOTH NS paths
    ns_schedule: Any = None
    # in-loop particle-number estimation (reference fxs_Projections.py:
    # 1098-1350, marked broken there; redesigned here as an exact threshold
    # histogram — see particle_number_estimate)
    pn_s: Any = None        # (K,) host: scales s_N = 1/√N − 1, aligned w/ pn_Ns
    pn_Ns: Any = None       # (K,) host: candidate particle numbers (ascending)
    pn_x: Any = None        # (K,) host: gradient abscissa (√N or N)
    pn_a: Any = None        # (n_q,) host: isotropic intensity I00·Y00 per shell
    pn_project: bool = False

    @classmethod
    def build(cls, projection_matrices, radial_points, l_max,
              used_order_ids=None, odd_orders_to_0=True,
              use_averaged_intensity=True, average_intensity=None,
              radial_mask=None, n_particles=1.0, schmidt_scaling=True,
              real_dtype=jnp.float32, procrustes_method="svd",
              ns_iterations=16, ns_schedule=None,
              pn_scan_space=None, pn_project=False):
        """Host-side assembly from extract-format data.

        projection_matrices: list of (n_q, min(2l+1, n_q)) complex V_l
        (the on-disk format of the reference, _database_.py:566-610)."""
        cdtype = jnp.complex64 if real_dtype == jnp.float32 else jnp.complex128
        n_q = len(radial_points)
        L = l_max
        n_m = 2 * L + 1
        V = np.zeros((L + 1, n_q, n_m), dtype=complex)
        for l in range(min(L + 1, len(projection_matrices))):
            vl = np.asarray(projection_matrices[l])
            if vl.ndim == 1:
                vl = vl[:, None]
            ncols = min(vl.shape[1], 2 * l + 1, n_q)
            V[l, :, L - l: L - l + ncols] = vl[:, :ncols]
        if odd_orders_to_0:
            V[1::2] = 0
        if use_averaged_intensity and average_intensity is not None:
            # I_00 = a(q)·2√π (orthonormal Y_00 = 1/(2√π));  fxs_Projections.py:706-710
            V[0] = 0
            V[0, :, L] = np.asarray(average_intensity).real * 2 * np.sqrt(np.pi)
        if schmidt_scaling:
            # reference scales all data matrices ×2 (fxs_Projections.py:711-713)
            V *= 2
        D2 = np.asarray(radial_points, dtype=float) ** 2
        PD = np.conj(np.swapaxes(V, 1, 2)) * D2[None, None, :]
        # identity on the complement of the centered window [L-l, L+l]
        eye_diag = np.ones((L + 1, n_m))
        for l in range(L + 1):
            eye_diag[l, L - l: L + l + 1] = 0.0
        use_order = np.zeros(L + 1, dtype=bool)
        if used_order_ids is None:
            used_order_ids = np.arange(L + 1)
        use_order[np.asarray(used_order_ids, dtype=int)] = True
        if radial_mask is None:
            radial_mask = np.ones((L + 1, n_q), dtype=bool)
        np_c = np.complex64 if real_dtype == jnp.float32 else np.complex128
        np_r = np.float32 if real_dtype == jnp.float32 else np.float64
        pn_s = pn_Ns = pn_x = pn_a = None
        if pn_scan_space is not None:
            lo, hi, k = pn_scan_space
            # √N-linear grid (reference 'project' spacing, :1125-1128)
            sq = np.linspace(np.sqrt(lo), np.sqrt(hi), int(k))
            pn_Ns = (sq ** 2).astype(np_r)
            pn_s = (1.0 / sq - 1.0).astype(np_r)   # descending in N
            pn_x = sq.astype(np_r) if pn_project else pn_Ns
            # isotropic contribution a(q) = I00(q)·Y00 = I00/(2√π); with the
            # averaged-intensity column I00 = avg·2√π this is avg itself
            pn_a = (np.abs(V[0, :, L].real) / (2 * np.sqrt(np.pi))
                    ).astype(np_r)
        return cls(V_pad=V.astype(np_c), PD=PD.astype(np_c),
                   eye_diag=eye_diag.astype(np_r),
                   use_order=np.asarray(use_order),
                   radial_mask=np.asarray(radial_mask),
                   n_particles=float(n_particles), l_max=L,
                   procrustes_method=procrustes_method,
                   ns_iterations=int(ns_iterations),
                   ns_schedule=tuple(map(tuple, ns_schedule))
                   if ns_schedule is not None else None,
                   pn_s=pn_s, pn_Ns=pn_Ns, pn_x=pn_x, pn_a=pn_a,
                   pn_project=bool(pn_project))

    def _ns_buckets(self):
        """NS crop buckets: [(l_lo, l_hi, h)] covering l ∈ [0, L−1], where
        bucket k = orders [64(k−1), min(64k−1, L−1)] on the centered window
        of half-width h = min(64k−1, L−1) (crop width 2h+1 = 127, 255,
        383, …)."""
        L, buckets, k = self.l_max, [], 1
        while 64 * (k - 1) <= L - 1:
            buckets.append((64 * (k - 1), min(64 * k - 1, L - 1),
                            min(64 * k - 1, L - 1)))
            k += 1
        return buckets

    # -- jittable ops ------------------------------------------------------
    def _eye_mat(self, dtype):
        """(L+1, n_m, n_m) complement identity, formed in-trace from the
        stored diagonal."""
        d = jnp.asarray(self.eye_diag)
        return (d[:, :, None]
                * jnp.eye(d.shape[1], dtype=d.dtype)).astype(dtype)

    def approximate_unknowns(self, Ilm):
        """Per-l Procrustes unitaries W_l from intensity coefficients.

        Ilm: (n_q, n_m, L+1) → W: (L+1, n_m, n_m). The centered padding makes
        M_l + eye_complement block-diagonal, so the polar factor restricts
        to the true (2l+1)² unitary on the valid block. Method 'svd' is
        exact; 'newton_schulz' is a matmul-only polar iteration
        (polar_unitary_newton_schulz)."""
        Ilt = jnp.moveaxis(Ilm, 2, 0)                      # (L+1, n_q, n_m)
        B = _mm("lmq,lqn->lmn", self.PD, Ilt)             # (L+1, n_m, n_m)
        if self.procrustes_method == "newton_schulz":
            # eye-pad the complement at the block's RMS singular-value scale:
            # any positive multiple of I has polar factor I, and matching the
            # scales keeps the Newton–Schulz normalization well conditioned
            sizes = 2 * jnp.arange(self.l_max + 1, dtype=B.real.dtype) + 1
            rms = jnp.sqrt(jnp.sum(jnp.abs(B) ** 2, axis=(-2, -1))
                           / sizes)[..., None, None]
            M = B + self._eye_mat(B.dtype) * (rms + 1e-20).astype(B.dtype)
            L, n_m = self.l_max, 2 * self.l_max + 1
            if n_m > 128 and L >= 1:
                # order bucketing: order l only needs the centered
                # (2l+1)-wide window, so orders are grouped into crops of
                # half-width 64k−1 (127, 255, …). At L = 128 this runs
                # l ≤ 63 on 127² blocks instead of 257² (NS FLOPs ×1.75
                # down); at L = 64 it reduces to the single (n_m−2) crop.
                # polar(blockdiag(A, rms·I)) =
                # blockdiag(polar(A), I), so cropping is exact; the l = L
                # block runs at full width.
                parts = []
                for (l_lo, l_hi, h) in self._ns_buckets():
                    sl = slice(L - h, L + h + 1)
                    Wb = polar_unitary_newton_schulz(
                        M[l_lo:l_hi + 1, sl, sl], self.ns_iterations,
                        schedule=self.ns_schedule)
                    idx = np.arange(n_m)
                    outside = ((idx < L - h) | (idx > L + h)).astype(
                        np.float32)
                    base = jnp.asarray(np.diag(outside)).astype(M.dtype)
                    W_full = jnp.broadcast_to(
                        base, (l_hi - l_lo + 1, n_m, n_m))
                    parts.append(W_full.at[:, sl, sl].set(Wb))
                parts.append(polar_unitary_newton_schulz(
                    M[L:], self.ns_iterations, schedule=self.ns_schedule))
                return jnp.concatenate(parts, axis=0)
            return polar_unitary_newton_schulz(M, self.ns_iterations,
                                               schedule=self.ns_schedule)
        u, _, vh = jnp.linalg.svd(B + self._eye_mat(B.dtype),
                                  full_matrices=False)
        return _mm("...ij,...jk->...ik", u, vh)

    def project_coefficients(self, Ilm, W):
        """Replace I_l by V_l·W_l on used orders/unmasked q
        (mtip_projection, fxs_Projections.py:792-872)."""
        Ilt = jnp.moveaxis(Ilm, 2, 0)                      # (L+1, n_q, n_m)
        proj = _mm("lqm,lmn->lqn", self.V_pad, W)          # (L+1, n_q, n_m)
        # l=0: fixed data column, no unknown (zero_id branch)
        proj = proj.at[0].set(self.V_pad[0])
        take = (self.use_order[:, None] & self.radial_mask)[:, :, None]
        out = jnp.where(take, proj, Ilt)
        # the 1/√N particle scaling divides the ENTIRE l=0 row — including
        # radially masked-out q that kept the iterate's coefficients
        # (reference generate_coeff_projection, fxs_Projections.py:866-870;
        # oracle-tested in tests/test_reference_oracle_phasing.py)
        out = out.at[0].mul(1.0 / float(np.sqrt(self.n_particles)))
        return jnp.moveaxis(out, 0, 2)                     # (n_q, n_m, L+1)

    def __call__(self, Ilm):
        return self.project_coefficients(Ilm, self.approximate_unknowns(Ilm))

    @property
    def pn_enabled(self):
        return self.pn_s is not None

    def particle_number_estimate(self, I):
        """Estimate the particle number from the projected intensity I on the
        angular grid and optionally project I to the estimate's scaling
        (reference particle_number_projection, fxs_Projections.py:1115-1196,
        which re-scans `scaled_I < 0` over a (K, grid) array per candidate;
        marked broken in the reference settings).

        Exact reformulation: a pixel turns negative under scale
        s exactly when s < −I/a (a = isotropic contribution per shell), so
        ALL K negative fractions come from one histogram of r = −I/a over
        the scale grid — no (K × grid) materialization, fully jittable.
        N̂ = argmax of the negative-fraction gradient (inflection heuristic).
        → (n_hat scalar, I [projected if pn_project])."""
        a = jnp.asarray(self.pn_a).reshape((-1,) + (1,) * (I.ndim - 1))
        s = jnp.asarray(self.pn_s)                  # descending in N
        Ns = jnp.asarray(self.pn_Ns)
        x = jnp.asarray(self.pn_x)
        pos = a > 0
        r = jnp.where(pos, -I / jnp.where(pos, a, 1.0), -jnp.inf).ravel()
        s_asc = s[::-1]
        # neg_asc[k] = frac(r > s_asc[k]) via bucketize + suffix counts
        bucket = jnp.searchsorted(s_asc, r, side="right")
        counts = jnp.bincount(bucket, length=s.shape[0] + 1)
        cum = jnp.cumsum(counts)
        neg_asc = (r.size - cum[:-1]) / r.size
        neg = neg_asc[::-1]                         # aligned with Ns ascending
        grad = (neg[1:] - neg[:-1]) / (x[1:] - x[:-1])
        idx = jnp.argmax(grad)
        n_hat = Ns[idx]
        if self.pn_project:
            I = jnp.maximum(I + s[idx] * a, 0.0)
        return n_hat, I


class RealCircularHarmonics:
    """Intensity ↔ circular-harmonic coefficients adapter for the 2D MTIP
    loop (reference dim-2 branch of harmonic_transforms.py:33-96): forward is
    an rfft over φ (real intensity ⇒ hermitian spectrum), inverse an irfft."""

    def __init__(self, n_phi: int, m_max: int):
        self.n_phi = int(n_phi)
        self.m_max = int(m_max)

    def forward(self, intensity):
        return jnp.fft.rfft(intensity, axis=-1)[..., : self.m_max + 1] / self.n_phi

    def inverse(self, coeff):
        n_half = self.n_phi // 2 + 1
        pad = n_half - coeff.shape[-1]
        if pad > 0:
            coeff = jnp.concatenate(
                [coeff, jnp.zeros(coeff.shape[:-1] + (pad,), coeff.dtype)],
                axis=-1)
        return jnp.fft.irfft(coeff * self.n_phi, self.n_phi, axis=-1)


@dataclass
class ReciprocalConstraintPolar:
    """2D data projection: per-m rank-1 vectors v_m with a phase unknown
    (reference fxs_Projections.py:723-750 `approximate_unknowns` 2D branch +
    mtip_projection). Operates on rfft-layout coefficients (n_q, M+1)."""
    V: Any               # (M+1, n_q) complex data vectors
    VD: Any              # (M+1, n_q) = conj(v_m)·q   (phase estimator; the
                         # reference 2D estimate weights by q — NOT q² as the
                         # 3D Procrustes does; fxs_Projections.py:736)
    use_order: Any       # (M+1,) bool
    radial_mask: Any     # (M+1, n_q) bool
    n_particles: float
    m_max: int
    so_pin_order: Any = None   # int: pin this order's phase unknown to 1
                               # (2D SO(2) gauge fix, reference
                               # generate_apply_SO_freedom_2D,
                               # fxs_Projections.py:973-1010)

    @classmethod
    def build(cls, projection_vectors, radial_points, m_max,
              used_order_ids=None, odd_orders_to_0=True,
              use_averaged_intensity=True, average_intensity=None,
              radial_mask=None, n_particles=1.0, real_dtype=jnp.float32,
              so_pin_order=None):
        np_c = np.complex64 if real_dtype == jnp.float32 else np.complex128
        n_q = len(radial_points)
        V = np.zeros((m_max + 1, n_q), dtype=complex)
        for m in range(min(m_max + 1, len(projection_vectors))):
            v = np.asarray(projection_vectors[m]).reshape(-1)
            V[m, : len(v)] = v[:n_q]
        if odd_orders_to_0:
            V[1::2] = 0
        if use_averaged_intensity and average_intensity is not None:
            V[0] = np.asarray(average_intensity).real
        D1 = np.asarray(radial_points, dtype=float)
        use_order = np.zeros(m_max + 1, dtype=bool)
        if used_order_ids is None:
            used_order_ids = np.arange(m_max + 1)
        use_order[np.asarray(used_order_ids, dtype=int)] = True
        if radial_mask is None:
            radial_mask = np.ones((m_max + 1, n_q), dtype=bool)
        return cls(V=V.astype(np_c), VD=(V.conj() * D1[None, :]).astype(np_c),
                   use_order=np.asarray(use_order),
                   radial_mask=np.asarray(radial_mask),
                   n_particles=float(n_particles), m_max=m_max,
                   so_pin_order=so_pin_order)

    def approximate_unknowns(self, Im):
        """Im: (n_q, M+1) → unit phases (M+1,)."""
        u = jnp.einsum("mq,qm->m", self.VD, Im, precision=_HI)
        mag = jnp.abs(u)
        phases = jnp.where(mag > 0, u / jnp.where(mag > 0, mag, 1.0), 1.0)
        if self.so_pin_order is not None:
            # fix the in-plane rotation gauge: the strongest order's unknown
            # is defined to be 1
            phases = phases.at[int(self.so_pin_order)].set(1.0)
        return phases

    def project_coefficients(self, Im, phases):
        proj = self.V * phases[:, None]                    # (M+1, n_q)
        proj = proj.at[0].set(self.V[0] / float(np.sqrt(self.n_particles)))
        take = self.use_order[:, None] & self.radial_mask
        out = jnp.where(take, proj, Im.T)
        return out.T                                       # (n_q, M+1)

    def __call__(self, Im):
        return self.project_coefficients(Im, self.approximate_unknowns(Im))


def project_to_modified_intensity(psi, intensity, new_intensity, eps=0.0):
    """ψ ← ψ·√(I_new/I) where both intensities are valid, else 0
    (fxs_Projections.py:874-929)."""
    valid = (intensity > eps) & (new_intensity.real >= 0)
    ratio = jnp.where(valid, new_intensity.real / jnp.where(valid, intensity, 1.0), 0.0)
    return psi * jnp.sqrt(ratio)


# ----------------------------------------------------------------- real side
@dataclass
class RealConstraint:
    """Support + value-threshold + limit-imag projection
    (RealProjection, fxs_Projections.py:26-155).

    considered_projections: which constraints' violation masks form the
    HIO/RAAR feedback region (reference HIOProjection, fxs_IO_methods.py:
    24-64 assemble_masks); ('all',) unions every applied constraint."""
    apply_support: bool = True
    apply_value_threshold: bool = True
    threshold_low: float | None = 0.0
    threshold_high: float | None = None
    apply_limit_imag: bool = True
    limit_imag: float = 2.0
    apply_assert_real: bool = False
    considered_projections: tuple = ("all",)

    def _considered(self, name):
        return "all" in self.considered_projections \
            or name in self.considered_projections

    def __call__(self, rho, support):
        """→ (projected density, invalid mask)."""
        invalid = jnp.zeros(rho.shape, dtype=bool)
        out = rho
        if self.apply_support:
            m = ~support
            out = jnp.where(m, 0.0, out)
            if self._considered("support"):
                invalid = invalid | m
        if self.apply_value_threshold and self.threshold_low is not None:
            m = out.real < self.threshold_low
            out = jnp.where(m, self.threshold_low + 1j * out.imag, out)
            if self._considered("value_threshold"):
                invalid = invalid | m
        if self.apply_value_threshold and self.threshold_high is not None:
            m = out.real > self.threshold_high
            out = jnp.where(m, self.threshold_high + 1j * out.imag, out)
            if self._considered("value_threshold"):
                invalid = invalid | m
        if self.apply_limit_imag:
            m = jnp.abs(out.imag) >= self.limit_imag
            out = jnp.where(m, out.real + 0.0j, out)
            if self._considered("limit_imag"):
                invalid = invalid | m
        if self.apply_assert_real:
            out = out.real + 0.0j
        return out, invalid


# ---------------------------------------------------------------- shrink wrap
def _fixed_volume_keep_bucketed(c, w, target, n_bins=512, n_levels=3):
    """Keep-mask whose weighted volume first reaches `target`, taking points
    in descending blur order — without sorting the grid.

    Three rounds of 512-way weighted-histogram refinement locate the
    boundary bin; bins above it are kept outright and the boundary set is
    filled in flat-index order by a masked cumsum. Membership is decided by
    the same bin INDEX the histogram counted (never by recomputed edge
    values — float rounding at bin edges could silently shift a whole tie
    level across the boundary), so the invariants
    weight(kept) < target <= weight(kept) + weight(boundary) hold exactly.
    Expected points in the final bin is n / n_bins**n_levels << 1, so this
    matches the sort-based rank selection except when several distinct
    values land in one final bin — a physically indistinguishable
    deviation of relative width (max-min)/2^27."""
    lo = jnp.min(c)
    span = jnp.max(c) - lo
    # width floor keeps the all-equal case (span == 0) well-formed; the
    # initial interval covers every point (max lands in the top bin)
    width = (span * (1.0 + 1e-6) + jnp.asarray(1e-30, c.dtype)) / n_bins
    alive = jnp.ones(c.shape, bool)   # candidates for the boundary bin
    kept = jnp.zeros(c.shape, bool)   # surely-kept (above the boundary bin)
    w_kept = jnp.asarray(0.0, w.dtype)
    for _ in range(n_levels):
        # truncation toward 0 is fine: alive points sit in [lo, lo+K·width)
        # up to float slop, and the clip bounds any stragglers
        idx = jnp.clip(((c - lo) / width).astype(jnp.int32), 0, n_bins - 1)
        histw = jnp.zeros((n_bins,), w.dtype).at[idx].add(
            jnp.where(alive, w, 0.0))
        suffix = jnp.cumsum(histw[::-1])[::-1]       # S[k] = Σ_{j>=k} histw
        ok = (w_kept + suffix) >= target             # monotone prefix of True
        b = jnp.maximum(jnp.sum(ok) - 1, 0)
        promote = alive & (idx > b)
        kept = kept | promote
        w_kept = w_kept + jnp.sum(jnp.where(promote, w, 0.0))
        alive = alive & (idx == b)
        lo = lo + b * width
        width = width / n_bins
    # fill the boundary bin in flat-index order; ok[b] guaranteed the bin
    # holds enough weight, ~ok[b+1] that residual > 0
    residual = target - w_kept
    cw = jnp.cumsum(jnp.where(alive, w, 0.0))
    # an element is kept while the cumulative weight BEFORE it is < residual
    # (same crossing-element-inclusive rule as searchsorted on the sort path)
    return kept | (alive & (cw - w < residual))


@dataclass
class ShrinkWrap:
    """Gaussian-blur support update (ShrinkWrapParts, fxs_Projections.py:178-298).

    blur via FT: multiply ψ=FT(|ρ|) by the analytic spherical FT of a Gaussian
    (mathLibrary.py gaussian_fourier_transformed_spherical), inverse-FT, then
    either threshold between min and max of the (clipped) convolution
    (mode='threshold') or pick the threshold hitting a target support volume
    (mode='fixed_volume', fxs_Projections.py:260-283). The reference searches
    the threshold by golden-section over repeated mask integrations; here
    the exact answer is one descending sort + weighted cumsum: the support is
    the set of highest-blur points whose integration weights sum to the
    target volume."""
    q_radii: Any              # broadcastable to grid, |q| per point
    default_sigma: float
    mode: str = "threshold"   # 'threshold' | 'fixed_volume'
    volume_fraction: float = 0.5   # target volume / initial-support volume
    vol_weights: Any = None   # host integration weights, zeroed outside the
    #                           initial support (fixed_volume mode only)
    initial_support: Any = None
    fixed_volume_method: str = "sort"   # 'sort' (exact ranks) | 'bucketed'
    #                                     (histogram refinement, O(n) passes)
    max_volume_change: Any = 0.2   # per-event volume rate limit (reference
    #                                d_vol_thresh, fxs_Projections.py:270-283:
    #                                thresholds changing the volume by more
    #                                than this fraction get an inf metric, so
    #                                the golden search converges to the target
    #                                over several SW events); None disables

    @classmethod
    def build(cls, qs, grid_rank=3, real_dtype=jnp.float32, mode="threshold",
              volume_fraction=0.5, integration_weights=None,
              initial_support=None, fixed_volume_method="sort",
              max_volume_change=0.2):
        np_real = np.float32 if real_dtype == jnp.float32 else np.float64
        q = np.asarray(qs, dtype=np_real).reshape((-1,) + (1,) * (grid_rank - 1))
        if mode == "fixed_volume":
            if integration_weights is None or initial_support is None:
                raise ValueError("fixed_volume shrink-wrap needs "
                                 "integration_weights and initial_support")
            w = np.asarray(integration_weights, dtype=np_real) \
                * np.asarray(initial_support)
        else:
            w = None
        mvc = None if max_volume_change in (None, False) \
            else float(max_volume_change)
        return cls(q_radii=q, default_sigma=float(np.pi / qs.max()),
                   mode=str(mode), volume_fraction=float(volume_fraction),
                   vol_weights=w,
                   initial_support=None if initial_support is None
                   else np.asarray(initial_support),
                   fixed_volume_method=str(fixed_volume_method),
                   max_volume_change=mvc)

    def gaussian_values(self, sigma):
        a = 1.0 / (2.0 * sigma ** 2)
        return jnp.sqrt(jnp.pi / a) * jnp.exp(-np.pi ** 2 * self.q_radii ** 2 / a)

    def new_support(self, conv, threshold, current_support=None):
        if self.mode == "fixed_volume":
            return self.new_support_fixed_volume(conv, current_support)
        c = jnp.maximum(conv.real, 0.0)
        cmax, cmin = jnp.max(c), jnp.min(c)
        return c >= cmin + threshold * (cmax - cmin)

    def new_support_fixed_volume(self, conv, current_support=None):
        """Support = highest-blur points (inside the initial support) whose
        integrated volume reaches volume_fraction × initial-support volume.

        'sort': exact quantile by descending sort + weighted cumsum —
        jit-friendly, no iterative search (reference fxs_Projections.py:260-283
        uses scipy golden-section per SW event). 'bucketed' avoids the
        full-grid argsort (O(n log n) multi-pass at 16.8M points) with
        three 512-way weighted-histogram refinements of the boundary value
        (O(n) elementwise passes) + one masked cumsum for the boundary bin.

        With max_volume_change set (reference default 0.2) and the current
        support given, the per-event target is clipped to within that
        fraction of the current support volume: the blur→volume map is
        monotone in the threshold, so the reference's inf-metric rejection
        of faster-changing thresholds makes its golden search land exactly
        on this clipped target (oracle-tested against the reference in
        tests/test_reference_oracle_phasing.py)."""
        c = conv.real.ravel()
        w = jnp.asarray(self.vol_weights).ravel()
        target = self.volume_fraction * w.sum()
        if self.max_volume_change is not None and current_support is not None:
            old = jnp.sum(w * current_support.ravel())
            target = jnp.clip(target, (1.0 - self.max_volume_change) * old,
                              (1.0 + self.max_volume_change) * old)
        if self.fixed_volume_method == "bucketed":
            keep = _fixed_volume_keep_bucketed(c, w, target)
        else:
            order = jnp.argsort(-c)
            cum = jnp.cumsum(w[order])
            pos = jnp.clip(jnp.searchsorted(cum, target), 0, c.size - 1)
            # rank-based membership (scatter), not a value comparison:
            # degenerate blur values (symmetric densities) would otherwise
            # pull whole iso-surfaces across the threshold and overshoot the
            # target volume
            keep = jnp.zeros(c.size, dtype=bool).at[order].set(
                jnp.arange(c.size) <= pos)
        return keep.reshape(conv.shape) & jnp.asarray(self.initial_support)


# -------------------------------------------------------------------- updates
def hio_update(rho_in, rho_p, rho_proj, invalid, beta):
    """Fienup hybrid input-output (fxs_IO_methods.py:40-64)."""
    return jnp.where(invalid, rho_in - beta * (rho_p - rho_proj), rho_proj)


def er_update(rho_proj):
    """Error reduction (fxs_IO_methods.py:67-68)."""
    return rho_proj


def raar_update(rho_in, rho_p, rho_proj, invalid, beta):
    """Relaxed averaged alternating reflections (Luke 2005, Inverse Problems
    21:37) — an IO-update the reference lacks (BASELINE.json north-star).

    x⁺ = (β/2)(R_S R_M + I)x + (1-β) P_M x reduces, for a pointwise support
    projector, to P_M x on valid points and β·x + (1-2β)·P_M x outside, with
    P_M x = rho_p (the modulus-projected density)."""
    return jnp.where(invalid, beta * rho_in + (1 - 2 * beta) * rho_p, rho_proj)
