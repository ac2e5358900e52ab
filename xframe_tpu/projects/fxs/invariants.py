"""The FXS invariant engine: B_l ↔ cross-correlation ↔ projection matrices.

Rebuilt from /root/reference/xframe/projects/fxs/projectLibrary/
fxs_invariant_tools.py. Conventions (verified against the reference's
formulas and kept self-consistent across simulate → extract → reconstruct):

  * intensity harmonic coefficients I_lm use orthonormal spherical harmonics
    (same as ops.sht), padded dense layout (n_q, n_m=2L+1, L+1).
  * B_l(q1,q2) = Σ_m I_lm(q1) I*_lm(q2)                (fxs_invariant_tools.py:915-923)
  * C_n(q1,q2) = Σ_l B_l · P̄_l^n(cosθ_1) P̄_l^n(cosθ_2)/(2l+1)
    with θ_i the Ewald-sphere polar angles                       (:578-645)
  * CC(q1,q2,Δ) = irfft(C_n)  over n_phi angular points

Extraction (CC → B_l) and eigen-decomposition (B_l → V_l) are setup-time,
float64, host-side numpy — replacing the reference's fork-based per-order
multiprocessing fan-out with vectorized array ops.
"""
from __future__ import annotations

import numpy as np

from xframe_tpu.library.legendre import sph_legendre_table, legendre_poly_table
from xframe_tpu.library.physics import ewald_sphere_theta_pi


# ------------------------------------------------------------------ PP matrices
def ewald_legendre_tables(thetas: np.ndarray, l_max: int) -> np.ndarray:
    """P̄_l^m(cosθ_q) tables, shape (n_q, m, l) with zeros for l<m."""
    return sph_legendre_table(l_max, np.cos(np.asarray(thetas)))


def pp_matrix_single_l(tables: np.ndarray, l: int) -> np.ndarray:
    """PP_l[q1,q2,n] = P̄_l^n(θ1)·P̄_l^n(θ2)/(2l+1) for n=0..l
    (reference ccd_associated_legendre_matrices_single_l, :61-76)."""
    col = tables[:, : l + 1, l]  # (n_q, n=0..l)
    return col[None, :, :] * col[:, None, :] / (2 * l + 1)


def pp_matrices(tables: np.ndarray) -> np.ndarray:
    """PP[q1,q2,n,l] = P̄_l^n(θ1)P̄_l^n(θ2)/(2l+1)  (reference :23-33)."""
    l_max = tables.shape[-1] - 1
    orders = np.arange(l_max + 1)
    return tables[None, :] * tables[:, None] / (2 * orders + 1)[None, None, None, :]


# ---------------------------------------------------------- invariants from I_lm
def harmonic_coeff_to_deg2_invariants_3d(coeff: np.ndarray) -> np.ndarray:
    """B_l = I_l I_l† from padded coefficients (n_q, n_m, L+1) → (L+1, n_q, n_q)."""
    return np.einsum("qml,pml->lqp", coeff, coeff.conj())


def harmonic_coeff_to_deg2_invariants_2d(coeff: np.ndarray) -> np.ndarray:
    """B_m = I_m(q1) I*_m(q2) from (n_q, n_m) → (n_m, n_q, n_q)."""
    return np.einsum("qm,pm->mqp", coeff, coeff.conj())


def projection_matrices_to_deg2_invariant_3d(proj_matrices) -> np.ndarray:
    """B_l = V_l V_l† (reference :1240-1254)."""
    n_q = proj_matrices[0].shape[0]
    out = np.zeros((len(proj_matrices), n_q, n_q), dtype=complex)
    for l, v in enumerate(proj_matrices):
        out[l] = v @ v.conj().T
    return out


# ------------------------------------------------------------------- B_l → CC
def deg2_invariant_to_cc_3d(bl: np.ndarray, xray_wavelength: float,
                            qs: np.ndarray, n_phi: int = None) -> np.ndarray:
    """Synthesize CC(q1,q2,Δ) from B_l via the PP relation + irfft
    (reference deg2_invariant_to_cc_3d 'back_substitution' mode, :962-990).

    Accumulates C_n per order — memory O(n_q²·L), never materializing the
    full (n_q², L²) PP tensor (which is terabytes at production grids; the
    reference fanned this out over worker processes for the same reason)."""
    l_max = bl.shape[0] - 1
    thetas = ewald_sphere_theta_pi(xray_wavelength, qs)
    tables = ewald_legendre_tables(thetas, l_max)
    n_q = len(qs)
    cns = np.zeros((n_q, n_q, l_max + 1), dtype=complex)
    for l in range(l_max + 1):
        if not np.any(bl[l]):
            continue
        col = pp_matrix_single_l(tables, l)       # (q1, q2, n<=l)
        cns[..., : l + 1] += bl[l][..., None] * col
    if n_phi is None:
        n_phi = 2 * (cns.shape[-1] - 1)
    return np.fft.irfft(cns * n_phi, n_phi, axis=-1)


def deg2_invariant_to_cc_2d(bm: np.ndarray, n_phi: int = None) -> np.ndarray:
    """2D: CC = irfft over the B_m axis (reference :938-943)."""
    bm = np.moveaxis(bm, 0, -1)
    if n_phi is None:
        n_phi = 2 * (bm.shape[-1] - 1)
    return np.fft.irfft(bm * n_phi, n_phi, axis=-1)


# ------------------------------------------------------------------- CC → B_l
def cc_to_deg2_invariant_3d(cc: np.ndarray, xray_wavelength: float,
                            qs: np.ndarray, l_max: int,
                            assume_zero_odd_orders: bool = True,
                            mode: str = "back_substitution") -> np.ndarray:
    """Extract B_l(q1,q2) from CC data; returns (L+1, n_q, n_q) complex.

    back_substitution: lazy triangular solve against the PP matrices
    (reference :578-645); lstsq: per-(q1,q2) least squares vs Legendre
    matrices F_l (reference :452-517)."""
    if mode in ("back_substitution", "back_substitution_memory_hungry"):
        # the reference's 'memory_hungry' twin materializes the full PP
        # tensor but computes the identical triangular solve
        # (fxs_invariant_tools.py:519-578); one vectorized path here
        return _cc_to_bl_back_substitution(cc, xray_wavelength, qs, l_max,
                                           assume_zero_odd_orders)
    if mode == "back_substitution_qqsym":
        return _cc_to_bl_back_substitution(cc, xray_wavelength, qs, l_max,
                                           assume_zero_odd_orders,
                                           symmetrize=True)
    if mode == "back_substitution_psd":
        return _cc_to_bl_back_substitution_psd(cc, xray_wavelength, qs,
                                               l_max, assume_zero_odd_orders)
    if mode == "lstsq":
        return _cc_to_bl_lstsq(cc, xray_wavelength, qs, l_max,
                               assume_zero_odd_orders)
    if mode == "legendre":
        return _cc_to_bl_legendre(cc, l_max, assume_zero_odd_orders)
    raise ValueError(f"unknown B_l extraction mode {mode!r}")


def _cc_to_bl_back_substitution(cc, xray_wavelength, qs, l_max,
                                assume_zero_odd_orders, symmetrize=False):
    """symmetrize=True is the reference's 'back_substitution_qqsym' variant
    (fxs_invariant_tools.py:647-695): both the C_n matrices and the Ewald
    PP columns are (q1,q2)-symmetrized before the triangular solve —
    averaging away the q1↔q2 asymmetry of noisy experimental CCs."""
    thetas = ewald_sphere_theta_pi(xray_wavelength, qs)
    tables = ewald_legendre_tables(thetas, l_max)
    n_phi = cc.shape[-1]
    stride = 2 if assume_zero_odd_orders else 1
    orders = np.arange(0, l_max + 1, stride)
    # harmonic coefficients of the CC over Δ (mathLibrary.py:484-490)
    ccn = np.fft.rfft(cc, axis=-1)[..., : l_max + 1 : stride] / n_phi
    ccn = ccn.astype(complex)
    if symmetrize:
        ccn = (ccn + np.swapaxes(ccn, 0, 1).conj()) / 2

    bl = np.zeros((l_max + 1,) + cc.shape[:2], dtype=complex)
    # lazy triangular back-substitution from l = L downward (reference :626-633)
    for l in orders[::-1]:
        col = pp_matrix_single_l(tables, l)[..., ::stride]  # (q1,q2,n<=l strided)
        if symmetrize:
            col = (col + np.swapaxes(col, 0, 1)) / 2
        bl[l] = ccn[..., -1] / col[..., -1]
        ccn = ccn[..., :-1] - bl[l][..., None] * col[..., :-1]
    return bl


def _cc_to_bl_back_substitution_psd(cc, xray_wavelength, qs, l_max,
                                    assume_zero_odd_orders):
    """The reference's 'back_substitution_psd' variant
    (fxs_invariant_tools.py:711-761 + mathLibrary.psd_back_substitution
    :1499-1507): the C_n matrices are projected to nearest-PSD up front,
    and every extracted B_l is PSD-projected BEFORE its contribution is
    subtracted from the remaining C_n — on noisy data this stops negative
    eigenvalue leakage from cascading down the triangular solve."""
    thetas = ewald_sphere_theta_pi(xray_wavelength, qs)
    tables = ewald_legendre_tables(thetas, l_max)
    n_phi = cc.shape[-1]
    # reference runs the psd solve at stride 1 over ALL orders and
    # subsamples afterwards (:757-760)
    ccn = np.fft.rfft(cc, axis=-1)[..., : l_max + 1] / n_phi
    ccn = np.stack([nearest_positive_semidefinite_matrix(ccn[..., n])
                    for n in range(ccn.shape[-1])], axis=-1).astype(complex)

    bl = np.zeros((l_max + 1,) + cc.shape[:2], dtype=complex)
    for l in range(l_max, -1, -1):
        col = pp_matrix_single_l(tables, l)                 # (q1,q2,n<=l)
        bl[l] = nearest_positive_semidefinite_matrix(ccn[..., -1]
                                                     / col[..., -1])
        ccn = ccn[..., :-1] - bl[l][..., None] * col[..., :-1]
    if assume_zero_odd_orders:
        bl[1::2] = 0
    return bl


def _cc_to_bl_legendre(cc, l_max, assume_zero_odd_orders):
    """Flat-Ewald 'legendre' extraction (reference fxs_invariant_tools.py:
    764-810, which calls flt's iterative fast DLT per (q1,q2) in worker
    processes): CC(q1,q2,Δ) = (1/4π) Σ_l B_l(q1,q2) P_l(cosΔ) when both
    Ewald circles are flat (θ1 = θ2 = π/2), so B_l = 4π × the Legendre
    coefficient of CC in x = cosΔ.

    The DLT here is EXACT in two dense matmuls instead of an iterative
    transform: the π-periodized CC is a cosine polynomial of degree N/2 in Δ,
    hence (cos nΔ = T_n(cosΔ)) a plain polynomial of degree N/2 in x.
    Trig-evaluate it at K Gauss-Legendre nodes and integrate with GL weights
    — exact once 2K−1 ≥ N/2 + l_max."""
    cc = enforce_pi_periodicity(np.asarray(cc, dtype=float))
    n_phi = cc.shape[-1]
    # cosine coefficients of the (real, even) CC over Δ
    r = np.fft.rfft(cc, axis=-1).real / n_phi              # (q1, q2, N/2+1)
    g = np.concatenate([r[..., :1], 2 * r[..., 1:-1], r[..., -1:]], axis=-1)
    K = n_phi // 2 + l_max + 1
    x, w = np.polynomial.legendre.leggauss(K)
    A = np.arccos(x)
    E = np.cos(np.outer(A, np.arange(g.shape[-1])))        # (K, N/2+1)
    f = g @ E.T                                            # CC at GL nodes
    stride = 2 if assume_zero_odd_orders else 1
    orders = np.arange(0, l_max + 1, stride)
    P = legendre_poly_table(l_max, x)[:, orders]           # (K, n_orders)
    a = np.einsum("abk,kl->lab", f * w, P) \
        * ((2 * orders + 1) / 2)[:, None, None]
    bl = np.zeros((l_max + 1,) + cc.shape[:2], dtype=complex)
    bl[orders] = 4 * np.pi * a
    return bl


def _cc_to_bl_lstsq(cc, xray_wavelength, qs, l_max, assume_zero_odd_orders,
                    row_chunk=None):
    """Vectorized per-(q1,q2) least squares: instead of n_q² serial
    np.linalg.lstsq calls (the reference fans these over fork processes,
    fxs_invariant_tools.py:477-480), form the normal equations
    G = FᵀF (n_orders × n_orders) and solve batched over q1-row chunks.
    F has full column rank for n_phi ≥ 2·l_max (Legendre design matrix),
    so the normal-equation solution equals lstsq to ~1e-9 relative in
    float64; a pinv fallback covers degenerate chunks."""
    thetas = ewald_sphere_theta_pi(xray_wavelength, qs)
    n_q = len(qs)
    n_phi = cc.shape[-1]
    phis = 2 * np.pi * np.arange(n_phi) / n_phi
    stride = 2 if assume_zero_odd_orders else 1
    orders = np.arange(0, l_max + 1, stride)
    ct, st = np.cos(thetas), np.sin(thetas)
    cosphi = np.cos(phis)
    bl = np.zeros((l_max + 1, n_q, n_q), dtype=complex)
    if row_chunk is None:
        # keep the (chunk, n_q, n_phi, L+1) Legendre table under ~1 GB
        row_chunk = max(1, int(1e9 / (n_q * n_phi * (l_max + 1) * 8)))
    for a0 in range(0, n_q, row_chunk):
        a1 = min(a0 + row_chunk, n_q)
        # F_l(q1,q2,Δ) = P_l(cosθ1 cosθ2 + sinθ1 sinθ2 cosΔ)/(4π)  (ref :79-97)
        arg = (ct[a0:a1, None, None] * ct[None, :, None]
               + st[a0:a1, None, None] * st[None, :, None]
               * cosphi[None, None, :])
        F = legendre_poly_table(l_max, arg)[..., orders] / (4 * np.pi)
        Ft = np.ascontiguousarray(F.transpose(0, 1, 3, 2))
        G = Ft @ F                                     # batched BLAS gemm
        rhs = (Ft @ cc[a0:a1, ..., None])[..., 0]
        try:
            sol = np.linalg.solve(G, rhs[..., None])[..., 0]
        except np.linalg.LinAlgError:
            sol = (np.linalg.pinv(G) @ rhs[..., None])[..., 0]
        bl[orders, a0:a1] = np.moveaxis(sol, -1, 0)
    return bl


def cc_to_deg2_invariant_2d(cc: np.ndarray, m_max: int) -> np.ndarray:
    """2D: B_m are the circular harmonic coefficients of the CC (reference :813-839)."""
    n_phi = cc.shape[-1]
    bm = np.fft.rfft(cc, axis=-1)[..., : m_max + 1] / n_phi
    return np.moveaxis(bm, -1, 0).astype(complex)


# ---------------------------------------------------------------- PSD / eigen
def nearest_positive_semidefinite_matrix(A: np.ndarray,
                                         low_positive_eigenvalues_to_zero=False):
    """Higham's nearest-PSD projection (reference mathLibrary.py:872-893)."""
    B = (A + np.swapaxes(A, -1, -2).conj()) / 2
    lam, v = np.linalg.eigh(B)
    limit = 0.0
    if low_positive_eigenvalues_to_zero:
        ev = np.linalg.eigvals(A)
        limit = np.abs(ev.min())
    lam = np.where(lam < limit, 0.0, lam)
    return (v * lam[..., None, :]) @ np.swapaxes(v, -1, -2).conj()


def _eig_sort_metric(lam, vec, sort_mode):
    """Eigen-pair ranking metric (reference deg2_invariant_eigenvalues,
    fxs_invariant_tools.py:1114-1141). sort_mode 0: by eigenvalue;
    sort_mode 1 ('median_of_scaled_eigenvector'): by the per-mode median of
    |√λ·v| signed by the eigenvalue sign — robust when a large eigenvalue
    carries a near-zero (numerically degenerate) eigenvector."""
    if sort_mode == 1:
        return np.median(np.abs(np.sqrt(np.abs(lam[None, :])) * vec),
                         axis=0) * np.sign(lam)
    return lam


def deg2_invariant_to_projection_matrices(bl: np.ndarray, q_id_limits=None,
                                          rank_cap=True, sort_mode=0):
    """Per-l eigendecomposition of B_l → V_l with B_l ≈ V_l V_l†.

    V_l has shape (n_q, min(n_q, 2l+1)); eigenvalues sorted descending by
    the sort_mode metric (see _eig_sort_metric), rank capped at 2l+1
    (rank_cap=False keeps all n_q non-negative modes — for diagnostics
    only; the physical rank of B_l is 2l+1), negatives clipped to 0
    (reference deg2_invariant_to_projection_matrices_3d, :1178-1210).
    Returns (list_of_V_l, eigenvalue_list)."""
    n_orders, n_q, _ = bl.shape
    proj, eigs = [], []
    for l in range(n_orders):
        if q_id_limits is not None:
            lo, hi = int(q_id_limits[l][0]), int(q_id_limits[l][1])
        else:
            lo, hi = 0, n_q
        sub = bl[l, lo:hi, lo:hi]
        sub = (sub + sub.conj().T) / 2
        cap = 2 * l + 1 if rank_cap else n_q
        NN = min(n_q, cap)
        if np.allclose(sub, 0):
            proj.append(np.zeros((n_q, NN), dtype=complex))
            eigs.append(np.zeros(NN))
            continue
        lam, vec = np.linalg.eigh(sub)
        order = np.argsort(_eig_sort_metric(lam.real, vec, sort_mode))[::-1]
        lam, vec = lam[order].real, vec[:, order]
        N = min(hi - lo, cap)
        lam, vec = lam[:N].copy(), vec[:, :N]
        neg = lam < 0
        lam[neg] = 0
        vec = vec.copy()
        vec[:, neg] = 0
        full_vec = np.zeros((n_q, NN), dtype=complex)
        full_lam = np.zeros(NN)
        full_vec[lo:hi, :N] = vec
        full_lam[:N] = lam
        proj.append(full_vec @ np.diag(np.sqrt(full_lam)))
        eigs.append(full_lam)
    return proj, eigs


def deg2_invariant_to_projection_vectors_2d(bm: np.ndarray, sort_mode=0):
    """2D: rank-1 factor of each B_m (reference :1146-1176). sort_mode 1
    picks the mode by median(|√λ·v|) instead of the raw eigenvalue — the
    case that motivated the reference's option (degenerate 2D spectra)."""
    proj, eigs = [], []
    for m in range(bm.shape[0]):
        sub = (bm[m] + bm[m].conj().T) / 2
        lam, vec = np.linalg.eigh(sub)
        i = np.argmax(_eig_sort_metric(lam.real, vec, sort_mode))
        val = max(lam[i].real, 0.0)
        v = vec[:, i] if val > 0 else np.zeros(sub.shape[0], dtype=complex)
        proj.append(v * np.sqrt(val))
        eigs.append(val)
    return np.array(proj), np.array(eigs)


# ----------------------------------------------------------------- rank orders
def rank_projection_matrices(proj_matrices, radial_points, radial_high_pass=0.2):
    """Order ranking by radial-weighted magnitude (reference :1437-1524,
    used by SO-freedom selection)."""
    n_low = int(len(radial_points) * radial_high_pass)
    scores = []
    for v in proj_matrices:
        v = np.atleast_2d(np.asarray(v))
        scores.append(np.abs(v[n_low:]).sum())
    ids = np.argsort(scores)[::-1]
    return ids, np.asarray(scores)[ids]


# ----------------------------------------------------- procrustes / prephasing
def solve_procrustes_problem(V1: np.ndarray, V2: np.ndarray) -> np.ndarray:
    """Unitary U minimizing ||V1 − V2·U|| via svd(V2†V1)
    (reference mathLibrary.py:1484-1490)."""
    u, _, vh = np.linalg.svd(V2.conj().T @ V1, full_matrices=False)
    return u @ vh


def pad_projection_matrices(proj, l_max: int, n_q: int) -> np.ndarray:
    """List of per-l (n_q, ≤2l+1) V_l → dense padded coefficient layout
    (n_q, n_m, L+1) with the centered-m window of ops.sht."""
    n_m = 2 * l_max + 1
    out = np.zeros((n_q, n_m, l_max + 1), dtype=complex)
    for l in range(min(l_max + 1, len(proj))):
        v = np.atleast_2d(np.asarray(proj[l]))
        if v.shape[0] != n_q:
            v = v.T
        ncols = min(v.shape[1], 2 * l + 1)
        out[:, l_max - l: l_max - l + ncols, l] = v[:, :ncols]
    return out


def unpad_projection_matrices(padded: np.ndarray, rank_cap=True) -> list:
    """Inverse of pad_projection_matrices."""
    n_q, n_m, n_l = padded.shape
    L = n_l - 1
    out = []
    for l in range(n_l):
        ncols = min(2 * l + 1, n_q) if rank_cap else 2 * l + 1
        out.append(padded[:, L - l: L - l + ncols, l].copy())
    return out


def enforce_sht_constraint(proj, sht, iterations=100, rel_err_limit=1e-6):
    """Iterative "prephasing" of the projection matrices: alternate between
    (a) the positivity/realness constraint of the intensity they synthesize
    and (b) the closest per-l unitary rotation back onto the original V_l
    (reference enforce_spherical_harmonic_transform_constraint,
    fxs_invariant_tools.py:1271-1296). Per-iteration work is one jitted
    SHT roundtrip + a batched procrustes."""
    import jax
    import jax.numpy as jnp

    L = sht.l_max
    n_q = np.atleast_2d(np.asarray(proj[0])).shape[0]
    P = pad_projection_matrices(proj, L, n_q)
    V = P.copy()

    @jax.jit
    def roundtrip(v_re, v_im):
        v = v_re + 1j * v_im
        I = sht.inverse(v)
        I = jnp.where(I.real < 0, 0.0, I.real).astype(v.dtype)
        return sht.forward(I)
    err_old = np.inf
    converged = False
    for i in range(iterations):
        Vnew = np.asarray(roundtrip(
            np.ascontiguousarray(V.real, dtype=np.float32),
            np.ascontiguousarray(V.imag, dtype=np.float32)))
        # per-l procrustes back onto the data matrices
        Vl = unpad_projection_matrices(Vnew)
        Pl = unpad_projection_matrices(P)
        rotated = [p @ solve_procrustes_problem(v, p)
                   for v, p in zip(Vl, Pl)]
        V = pad_projection_matrices(rotated, L, n_q)
        if i % 10 == 9:
            err = float(np.abs(Vnew - V).sum() / max(np.abs(V).sum(), 1e-30))
            if err_old != np.inf and abs(err_old - err) / max(err_old, 1e-30) \
                    < rel_err_limit:
                converged = True
                break
            err_old = err
    return unpad_projection_matrices(V), converged


# ---------------------------------------------- unknown unitary between datasets
def projection_matrix_error_estimate(bl, proj):
    """Per-order relative reconstruction error |B_l - V_l V_l^dag| / |B_l| on
    nonzero entries, -1 elsewhere (reference
    calc_projection_matrix_error_estimate, fxs_invariant_tools.py:1259-1268)."""
    bl = np.asarray(bl)
    errors = np.full(bl.shape, -1.0)
    for l in range(bl.shape[0]):
        b = bl[l]
        pr = np.atleast_2d(np.asarray(proj[l])) if l < len(proj) else None
        if pr is None:
            continue
        if pr.shape[0] != b.shape[0]:
            pr = pr.T
        nz = b != 0
        rec = pr @ pr.conj().T
        errors[l][nz] = np.abs(b - rec)[nz] / np.abs(b[nz])
    return errors


def calc_unknown_unitary_transform(proj_1, eig_1, proj_2, eig_2, b_21,
                                   radial_points, q_id_limits=None,
                                   method="procrustes"):
    """Unitary W_l relating the unknowns of two datasets (e.g. I2I1) from the
    mixed invariant B_21 = V2 U2 U1† V1† (reference
    fxs_invariant_tools.py:1297-1436). → (list of W_l, relative errors)."""
    n_orders = len(proj_1)
    n_q = b_21.shape[-1]
    if q_id_limits is None:
        q_id_limits = np.zeros((n_orders, 2, 2), dtype=int)
        q_id_limits[..., 1] = n_q
    W, errors = [], np.full_like(b_21, -1.0, dtype=float)
    for o in range(n_orders):
        lim = q_id_limits[o]
        s2, s1 = slice(*lim[0]), slice(*lim[1])
        b = b_21[o][s2, s1]
        N1 = min(lim[1, 1] - lim[1, 0], 2 * o + 1)
        N2 = min(lim[0, 1] - lim[0, 0], 2 * o + 1)
        v1 = np.atleast_2d(np.asarray(proj_1[o]))[s1, :N1].copy()
        v2 = np.atleast_2d(np.asarray(proj_2[o]))[s2, :N2].copy()
        e1 = np.asarray(eig_1[o])[:N1]
        pos = e1 > 0
        v1d = v1.copy()
        v1d[:, ~pos] = 0
        v1d[:, pos] /= e1[None, pos]
        if method == "direct":
            e2 = np.asarray(eig_2[o])[:N2]
            pos2 = e2 > 0
            v2d = v2.copy()
            v2d[:, ~pos2] = 0
            v2d[:, pos2] /= e2[None, pos2]
            w = v2d.conj().T @ b @ v1d
        else:
            target = (np.asarray(radial_points)[s2, None] * b) @ v1d
            w = solve_procrustes_problem(target, v2)
        W.append(w)
        nz = b != 0
        err = np.full(b.shape, -1.0)
        err[nz] = np.abs(b[nz] - (v2 @ w @ v1.conj().T)[nz]) / np.abs(b[nz])
        errors[o][s2, s1] = err
    return W, errors


# -------------------------------------------------- particle-number estimation
def estimate_number_of_particles(proj_matrices, sht, search_space=(1.0, 10.0, 64),
                                 average_intensity=None, method="onset",
                                 onset_threshold=1e-4):
    """Estimate the number of particles from the projection matrices: scan a
    scale s applied to the isotropic coefficient (I_00/s) and track the
    negative-intensity volume fraction, which transitions from ~0 to growing
    at s ≈ √n_particles (reference estimate_number_of_particles,
    fxs_invariant_tools.py:1583-1860). The scan is one jitted vmap.

    method='onset' locates the first scale whose negative fraction exceeds
    `onset_threshold` (scales ∝ √n robustly); method='gradient' reproduces
    the reference's argmax|d(neg)/ds| inflection heuristic.

    → (n_particles, gradient curve, negative fractions, scales)."""
    import jax
    import jax.numpy as jnp

    L = sht.l_max
    n_q = np.atleast_2d(np.asarray(proj_matrices[0])).shape[0]
    V = pad_projection_matrices(proj_matrices, L, n_q)
    if average_intensity is not None:
        V[:, :, 0] = 0
        V[:, L, 0] = np.abs(np.asarray(average_intensity)) * 2 * np.sqrt(np.pi)
    I00 = np.abs(V[:, L, 0]).real
    scales = np.linspace(*search_space)

    @jax.jit
    def negative_fractions(v_re, v_im, i00):
        I = sht.inverse(v_re + 1j * v_im).real          # (n_q, nθ, nφ)
        base = i00[:, None, None] / (2 * np.sqrt(np.pi))

        def frac(s):
            I_s = I + (1.0 / s - 1.0) * base
            return jnp.mean(I_s < 0)

        return jax.vmap(frac)(jnp.asarray(scales, dtype=jnp.float32))

    neg = np.asarray(negative_fractions(
        np.ascontiguousarray(V.real, dtype=np.float32),
        np.ascontiguousarray(V.imag, dtype=np.float32),
        np.asarray(I00, dtype=np.float32)))
    grad = np.gradient(neg, scales[1] - scales[0])
    if method == "gradient":
        s_star = scales[np.argmax(np.abs(grad))]
    else:
        above = np.nonzero(neg > onset_threshold)[0]
        s_star = scales[above[0]] if len(above) else scales[-1]
    return float(s_star ** 2), grad, neg, scales


# -------------------------------------------------------------------- CC masks
def cc_mask(qs, phis, mask_type="none", xray_wavelength=None, pixel_size=None,
            mask_at_pi=True, threshold=0.01, custom=None,
            n_masked_pixels_phi=0.0, n_masked_pixels_q=0.0):
    """Cross-correlation validity masks (n_q, n_q, n_phi) — regions of the
    CC plane dominated by detector artifacts (reference
    fxs_invariant_tools.py:100-232).

    none        : all true
    pixel_arc   : mask pairs of Ewald-sphere points closer (arc length) than
                  the reciprocal feature size 2π/pixel_size (optionally also
                  around Δ=π)
    pixel_flat  : flat-detector variant — mask Δ≈0 (and π) where q1≈q2
    pixel_custom: mask fixed FRACTIONS of Δ pixels around Δ=0 (and π), only
                  for q-pairs with |q1_id − q2_id| ≤ n_q·n_masked_pixels_q
                  (reference pixel_custom_cc_mask, :140-171)
    donatelli   : |q1±q2|²-style threshold (Donatelli PNAS 2018 suppl.)
    direct      : user-provided boolean array
    """
    qs = np.asarray(qs, dtype=float)
    phis = np.asarray(phis, dtype=float)
    n_q, n_phi = len(qs), len(phis)
    if mask_type == "none":
        return np.ones((n_q, n_q, n_phi), dtype=bool)
    if mask_type == "direct":
        return np.asarray(custom, dtype=bool)

    if mask_type == "pixel_custom":
        n = int(n_phi * float(n_masked_pixels_phi))
        nq = int(n_q * float(n_masked_pixels_q))
        pi_index = n_phi // 2
        ids = list(range(n)) + list(range(n_phi - n, n_phi))
        if mask_at_pi and n > 0:
            # reference-exact window (fxs_invariant_tools.py:160): 2n-2 ids,
            # asymmetric around pi and EMPTY for n=1 — parity, not a bug
            ids += list(range(pi_index - (n - 1), pi_index + (n - 1)))
        mask = np.ones((n_q, n_q, n_phi), dtype=bool)
        if ids:
            mask[..., np.asarray(ids) % n_phi] = False
        # only q-pairs within nq index bands keep the Δ masking
        far = np.abs(np.arange(n_q)[:, None]
                     - np.arange(n_q)[None, :]) > nq
        mask[far] = True
        return mask

    if mask_type == "donatelli":
        thetas = ewald_sphere_theta_pi(xray_wavelength, qs)
        ct, st = np.cos(thetas), np.sin(thetas)
        a = (qs ** 2)[:, None, None] + (qs ** 2)[None, :, None]
        b = 2 * qs[:, None, None] * qs[None, :, None] * (
            ct[:, None, None] * ct[None, :, None]
            + st[:, None, None] * st[None, :, None]
            * np.cos(phis)[None, None, :])
        return ~((a + b < threshold) | (a - b < threshold))

    r_pix = 2 * np.pi / float(pixel_size)
    if mask_type == "pixel_arc":
        # Ewald-sphere points: shift the scattering vectors to the sphere
        # center and measure great-circle distance
        thetas = ewald_sphere_theta_pi(xray_wavelength, qs)
        ewald_r = 2 * np.pi / xray_wavelength
        z = np.broadcast_to((qs * np.cos(thetas) - ewald_r)[:, None],
                            (n_q, n_phi))
        cart = np.stack([
            qs[:, None] * np.sin(thetas)[:, None] * np.cos(phis)[None, :],
            qs[:, None] * np.sin(thetas)[:, None] * np.sin(phis)[None, :],
            z,
        ], axis=-1)                                  # (n_q, n_phi, 3)
        sph_theta = np.arccos(np.clip(cart[..., 2]
                                      / np.linalg.norm(cart, axis=-1),
                                      -1, 1))[:, 0]  # φ-independent
        ct, st = np.cos(sph_theta), np.sin(sph_theta)

        def arc(phi_vals):
            cosarc = ct[:, None, None] * ct[None, :, None] \
                + st[:, None, None] * st[None, :, None] \
                * np.cos(phi_vals)[None, None, :]
            return np.abs(ewald_r * np.arccos(np.clip(cosarc, -1, 1)))

        mask = arc(phis) > r_pix
        if mask_at_pi:
            mask &= arc(phis - np.pi) > r_pix
        return mask
    if mask_type == "pixel_flat":
        with np.errstate(divide="ignore"):
            # angular extent of one reciprocal pixel on the ring of radius q
            phi_min = np.where(qs > 0, r_pix / np.where(qs > 0, qs, 1.0),
                               np.inf)
        phi_mask = (phis[None, :] > phi_min[:, None]) \
            & (phis[None, :] < 2 * np.pi - phi_min[:, None])
        if mask_at_pi:
            phi_mask &= (phis[None, :] > np.pi + phi_min[:, None]) \
                | (phis[None, :] < np.pi - phi_min[:, None])
        phi_mask = phi_mask[None, :, :] & phi_mask[:, None, :]
        radial_mask = np.abs(qs[None, :] - qs[:, None]) > r_pix
        return radial_mask[:, :, None] | phi_mask
    raise ValueError(f"unknown cc mask type {mask_type!r}")


def interpolate_masked_cc(cc, mask, row_chunk=65536, use_native=True):
    """Fill masked Δ entries of each (q1,q2) row by periodic linear
    interpolation from the unmasked neighbors (reference
    interpolate_masked_cc, fxs_invariant_tools.py:335-351).

    Primary path is the native C++ row kernel (one O(n_phi) pass per row,
    threaded — sub-second at n_q=512); fallback is vectorized numpy over
    row chunks. Both replace the reference's per-(q1,q2) Python loop."""
    # one fresh float64-contiguous buffer: ascontiguousarray already
    # materializes a copy for non-f64/non-contiguous inputs, so only the
    # passthrough case needs an explicit .copy()
    if (isinstance(cc, np.ndarray) and cc.dtype == np.float64
            and cc.flags.c_contiguous):
        cc = cc.copy()
    else:
        cc = np.ascontiguousarray(cc, dtype=np.float64)
    mask = np.asarray(mask, dtype=bool)
    n_phi = cc.shape[-1]
    flat_c = cc.reshape(-1, n_phi)
    flat_m = mask.reshape(-1, n_phi)
    if use_native:
        from xframe_tpu import native
        if native.interp_masked_rows(flat_c, flat_m):
            return cc
    rows = np.nonzero(~flat_m.all(axis=-1))[0]
    if len(rows) == 0:
        return cc
    idx3 = np.arange(3 * n_phi)
    x_mid = idx3[n_phi: 2 * n_phi]
    for c0 in range(0, len(rows), row_chunk):
        r = rows[c0: c0 + row_chunk]
        m = flat_m[r]                                 # (P, n)
        c = flat_c[r]
        none_good = ~m.any(axis=-1)
        m3 = np.concatenate([m, m, m], axis=-1)       # periodic extension
        c3 = np.concatenate([c, c, c], axis=-1)
        # nearest good sample at-or-left / at-or-right of every position
        left = np.maximum.accumulate(
            np.where(m3, idx3[None, :], -1), axis=-1)[:, n_phi: 2 * n_phi]
        right = np.minimum.accumulate(
            np.where(m3, idx3[None, :], 3 * n_phi)[:, ::-1],
            axis=-1)[:, ::-1][:, n_phi: 2 * n_phi]
        # bad rows with ≥1 good point always have a strict left<x<right pair
        left_c = np.clip(left, 0, 3 * n_phi - 1)
        right_c = np.clip(right, 0, 3 * n_phi - 1)
        rp = np.arange(len(r))[:, None]
        fL, fR = c3[rp, left_c], c3[rp, right_c]
        den = np.maximum(right_c - left_c, 1)
        vals = fL + (x_mid[None, :] - left_c) / den * (fR - fL)
        filled = np.where(m, c, vals)
        filled[none_good] = 0.0
        flat_c[r] = filled
    return cc


def enforce_pi_periodicity(cc, mask=None):
    """Enforce CC(Δ) = CC(Δ+π) (Friedel symmetry of the intensity on a flat
    Ewald sphere; reference modify_cross_correlation pi_periodicity,
    fxs_invariant_tools.py:263-270).

    Without a mask: plain average of the two Δ-halves. With a mask:
    mask-weighted mean of CC(Δ) and CC(Δ+π), returning (cc, mask|mask_π) —
    the reference instead COPIES the Δ∈[π/2,3π/2) half over the other and
    or's the masks; the masked mean reduces to that copy wherever only one
    sample is valid and uses both (noise-averaging) where both are."""
    cc = np.asarray(cc)
    n2 = cc.shape[-1] // 2
    rolled = np.roll(cc, n2, axis=-1)
    if mask is None:
        return 0.5 * (cc + rolled)
    mask = np.asarray(mask, dtype=bool)
    rm = np.roll(mask, n2, axis=-1)
    w = mask.astype(float) + rm.astype(float)
    out = np.where(w > 0, (cc * mask + rolled * rm) / np.maximum(w, 1), 0.0)
    return out.astype(cc.dtype, copy=False), mask | rm


def symmetrize_cc_q1q2(cc, mask):
    """Enforce cc(q1,q2,Δ) = cc(q2,q1,−Δ): mask-aware average of the CC with
    its Δ-reversed transpose — Δ=0 maps to itself, Δ_k ↔ Δ_{n−k} — where
    both samples are valid; the one valid sample elsewhere; the combined
    mask is the union (reference modify_cross_correlation q1q2_symmetric,
    fxs_invariant_tools.py:271-281 masked_mean). → (cc, mask)."""
    cc = np.asarray(cc)
    mask = np.asarray(mask, dtype=bool)
    sw = np.array(cc)
    sw[..., 1:] = cc[..., 1:][..., ::-1]
    swm = np.array(mask)
    swm[..., 1:] = mask[..., 1:][..., ::-1]
    sw = np.swapaxes(sw, 0, 1)
    swm = np.swapaxes(swm, 0, 1)
    w = mask.astype(float) + swm.astype(float)
    out = np.where(w > 0, (cc * mask + sw * swm) / np.maximum(w, 1), 0.0)
    return out.astype(cc.dtype, copy=False), mask | swm


def zero_cc_harmonics(cc, max_order=None, zero_odd=False):
    """enforce_max_order / enforce_zero_odd_harmonics CC modifications
    (reference modify_cross_correlation, fxs_invariant_tools.py:253-262):
    circular harmonics C_n above max_order cannot contribute to B_l with
    l ≤ max_order, and π-symmetry of the CC makes odd harmonics zero."""
    f = np.fft.rfft(np.asarray(cc, dtype=float), axis=-1)
    if max_order is not None:
        f[..., int(max_order) + 1:] = 0
    if zero_odd:
        f[..., 1::2] = 0
    return np.fft.irfft(f, cc.shape[-1], axis=-1)


def low_pass_cc_in_q(cc, cutoff):
    """low_pass_order_in_q: first-order Butterworth low-pass along the q1
    and q2 axes (reference fxs_invariant_tools.py:248-252)."""
    from scipy.signal import butter, sosfilt
    sos = butter(1, float(cutoff), "lp", fs=len(cc), output="sos")
    cc = sosfilt(sos, np.asarray(cc, dtype=float), axis=0)
    return sosfilt(sos, cc, axis=1)


def binned_mean_cc(cc, mask, max_order, phis):
    """apply_binned_mean: re-bin the Δ axis to 2·max_order bins of width
    π/max_order by masked averaging (reference binned_mean,
    fxs_invariant_tools.py:308-332). → (cc, mask, phis) on the new grid."""
    phis = np.asarray(phis, dtype=float)
    step = np.pi / int(max_order)
    n_bins = 2 * int(max_order)
    ids = ((phis + step / 2) // step).astype(int)
    n_roll = int(np.sum(ids == n_bins))
    ids[ids == n_bins] = 0
    ccr = np.roll(np.asarray(cc, dtype=float), n_roll, axis=-1)
    mr = np.roll(np.asarray(mask, dtype=bool), n_roll, axis=-1)
    idr = np.roll(ids, n_roll)
    ccr[~mr] = 0.0
    split = np.where(np.roll(idr, 1) != idr)[0]
    new_cc = np.add.reduceat(ccr, split, axis=-1)
    counts = np.add.reduceat(mr.astype(int), split, axis=-1)
    new_mask = counts != 0
    new_cc[new_mask] /= counts[new_mask]
    new_phis = np.arange(n_bins) * 2 * np.pi / n_bins
    return new_cc, new_mask, new_phis


# ------------------------------------------------------- per-order q-id limits
def _distance_from_line(p1, p2, orders, qs):
    """Signed distance of every (order, q) grid point from the line p1→p2
    in (order, q) space (reference mathLibrary.py:1131-1137)."""
    p1, p2 = np.asarray(p1, dtype=float), np.asarray(p2, dtype=float)
    d = p2 - p1
    normal = np.array([d[1], -d[0]])
    return ((orders[:, None] - p1[0]) * normal[0]
            + (qs[None, :] - p1[1]) * normal[1])


def line_q_id_limits(qs, l_max, min_line=None, max_line=None, q_mask=None):
    """Per-order B_l q-limit 'line' masks (reference
    calc_deg_2_invariant_masks + calc_deg_2_invariant_line_mask,
    extract.py:332-414): a line [(l_start, q_start), (l_stop, q_stop)] in
    (order, q) space bounds the usable q range of each order from below
    (min_line) and/or above (max_line).

    Returns (mask, q_id_limits): mask (l_max+1, n_q, n_q) bool — the outer
    product of each order's 1-D q validity with itself — and q_id_limits
    (l_max+1, 2) int with the [lo, hi) slice of each order (clamped to the
    detector q_mask extent)."""
    qs = np.asarray(qs, dtype=float)
    n_q = len(qs)
    orders = np.arange(l_max + 1, dtype=float)
    limits = np.zeros((l_max + 1, 2), dtype=int)
    limits[:, 1] = n_q

    row_masks = np.ones((l_max + 1, n_q), dtype=bool)
    if min_line is not None:
        m = -_distance_from_line(min_line[0], min_line[1], orders, qs) >= 0
        # all-masked orders get [n_q-1, n_q) rather than an empty range —
        # reference-exact (extract.py:381-384 sets q_id = n_qs-1 there); the
        # all-False row mask is what excludes the order downstream
        lo = np.where(m.any(axis=1), np.argmax(m, axis=1), n_q - 1)
        limits[:, 0] = lo
        row_masks &= m
    if max_line is not None:
        # valid-for-max region: the complement of the min-style half-plane
        # (reference invert=True branch, extract.py:385-393)
        m = _distance_from_line(max_line[0], max_line[1], orders, qs) > 0
        hi = np.where(m.all(axis=1), n_q, np.argmin(m, axis=1))
        limits[:, 1] = hi
        row_masks &= m

    if q_mask is not None:
        q_mask = np.asarray(q_mask, dtype=bool)
        q_lo = int(np.argmax(q_mask))
        q_hi = n_q - int(np.argmax(q_mask[::-1]))
        limits[:, 0] = np.maximum(limits[:, 0], q_lo)
        limits[:, 1] = np.minimum(limits[:, 1], q_hi)
        row_masks &= q_mask[None, :]
    limits[:, 1] = np.maximum(limits[:, 1], limits[:, 0])

    mask = row_masks[:, :, None] & row_masks[:, None, :]
    return mask, limits


def apply_psd_on_q_limits(bl, q_id_limits):
    """PSD-project each order's [lo, hi) sub-block only (reference
    apply_invariant_constraints, extract.py:417-430): entries outside an
    order's q-limits carry no constraint and stay untouched."""
    out = np.array(bl, copy=True)
    for l in range(len(bl)):
        lo, hi = int(q_id_limits[l][0]), int(q_id_limits[l][1])
        if hi - lo < 1:
            continue
        out[l, lo:hi, lo:hi] = nearest_positive_semidefinite_matrix(
            bl[l, lo:hi, lo:hi])
    return out
