"""Centering, SO(3) rotational alignment, and averaging of reconstructions.

Rebuilt from the reference average worker's Alignment machinery
(reference projects/fxs/average.py:729-1110): centering is a reciprocal-space
phase ramp, rotation search is the SO(3) cross-correlation of per-shell SH
coefficients (ops.so3 — replacing the numba pysofft plugin), point inversion
is the parity flip f_lm → (-1)^l f_lm, and everything runs as jitted device
ops batched over candidates.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from xframe_tpu.library.shapes import spherical_to_cartesian
from xframe_tpu.ops.so3 import SO3Correlator, rotate_coeff, wigner_D_single


class _CandidateSharding:
    """Mixin: shard the batched-alignment candidate axis over a device mesh
    (the average-side analog of MultiStartRunner's restart axis — candidates
    are embarrassingly parallel through centering/correlation/rotation, so
    average scales with chips like reconstruct; VERDICT r3 #7)."""

    def _init_mesh(self, mesh):
        self._cspec = None
        self._n_shards = 0
        if mesh is not None:
            from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
            flat = Mesh(np.asarray(mesh.devices).reshape(-1), ("candidates",))
            self._cspec = NamedSharding(flat, P("candidates"))
            self._n_shards = int(flat.devices.size)

    def _shard_cands(self, arr):
        """→ (possibly padded + sharded array, original row count)."""
        arr = jnp.asarray(arr)
        n = int(arr.shape[0])
        if self._cspec is None:
            return arr, n
        from xframe_tpu.parallel.mesh import _pad_restarts
        arr = _pad_restarts(arr, self._n_shards)
        return jax.device_put(arr, self._cspec), n


class Aligner(_CandidateSharding):
    """Bundles the transforms + SO(3) correlator for one internal grid."""

    def __init__(self, ft, integration_weights, r_limit_ids=None,
                 bandwidth=None, l_max_align=None, real_dtype=jnp.float32,
                 mesh=None):
        """l_max_align caps the harmonic band used for the rotation SEARCH
        (the Wigner-d table grows as O(n_β·L·(2L+1)²) — at L=64 it would be a
        ~0.5 GB program constant); the final rotation is still applied at the
        full band limit. Accuracy of the cap is bounded by
        tests/test_average_batch.py::test_band_cap_* (angle error vs the full
        band on known rotations).

        mesh: optional jax.sharding.Mesh — the batched paths shard their
        candidate axis over ALL its devices."""
        self.ft = ft
        self._init_mesh(mesh)
        self.sht = ft.sht
        L = ft.sht.l_max
        self.l_align = min(int(l_max_align), L) if l_max_align else min(L, 32)
        self.corr = SO3Correlator(self.l_align, bandwidth=bandwidth,
                                  real_dtype=real_dtype)
        n_r = ft.n_radial_points
        if r_limit_ids is None:
            r_limit_ids = np.arange(n_r)
        w = np.zeros(n_r)
        w[np.asarray(r_limit_ids, dtype=int)] = \
            np.asarray(ft.rs)[np.asarray(r_limit_ids, dtype=int)] ** 2
        self._w_r = w / max(w.sum(), 1e-30)
        self._w_int = np.asarray(integration_weights)
        # parity: Y_lm(-x) = (-1)^l Y_lm(x)
        self._parity = (-1.0) ** np.arange(L + 1)
        grid_sph = np.stack(np.meshgrid(np.asarray(ft.qs), ft.sht.theta,
                                        ft.sht.phi, indexing="ij"), axis=-1)
        self._q_cart = spherical_to_cartesian(grid_sph)  # (n_q,nθ,nφ,3)

        self._coeffs = jax.jit(self.sht.forward)
        self._synth = jax.jit(lambda c: self.sht.inverse(c))
        self._correlate = jax.jit(partial(self.corr.correlate,
                                          radial_weights=self._w_r))
        self._ft_fwd = jax.jit(ft.forward)
        self._ft_inv = jax.jit(ft.inverse)

        @jax.jit
        def _center(rho):
            """Move the |ρ| center of mass to the origin via a reciprocal
            phase ramp (reference average.py:1021-1025)."""
            w = jnp.abs(rho) * self._w_int
            total = jnp.sum(w)
            com = jnp.einsum("rtp,rtpc->c", w,
                             jnp.asarray(self._r_cart()),
                             precision="highest") / total
            psi = ft.forward(rho)
            phase = jnp.exp(1j * jnp.einsum(
                "rtpc,c->rtp", jnp.asarray(self._q_cart),
                com, precision="highest").astype(psi.dtype))
            return ft.inverse(psi * phase), com

        self._center_fn = _center

    def _r_cart(self):
        if not hasattr(self, "_r_cart_cache"):
            grid_sph = np.stack(np.meshgrid(np.asarray(self.ft.rs),
                                            self.sht.theta, self.sht.phi,
                                            indexing="ij"), axis=-1)
            self._r_cart_cache = spherical_to_cartesian(grid_sph)
        return self._r_cart_cache

    # ------------------------------------------------------------------- ops
    def center(self, rho):
        return self._center_fn(rho)

    def coefficients(self, rho):
        return self._coeffs(rho)

    def invert_parity(self, coeff):
        if not hasattr(self, "_parity_fn"):
            self._parity_fn = jax.jit(
                lambda c: c * self._parity[None, None, :])
        return self._parity_fn(coeff)

    def _truncate(self, coeff):
        """Full-band centered layout → the alignment band (centered window)."""
        L, La = self.sht.l_max, self.l_align
        if La == L:
            return coeff
        return coeff[..., L - La: L + La + 1, : La + 1]

    def find_rotation(self, ref_coeff, coeff):
        """→ (α,β,γ) maximizing Re⟨Λ(R)·coeff, ref_coeff⟩."""
        C = np.asarray(self._correlate(self._truncate(ref_coeff),
                                    self._truncate(coeff)))
        ia, ib, ig = np.unravel_index(np.argmax(C), C.shape)
        return (float(self.corr.alphas[ia]), float(self.corr.betas[ib]),
                float(self.corr.gammas[ig])), float(C[ia, ib, ig])

    def rotate(self, coeff, angles):
        """Rotate SH coefficients by Euler angles; D is built at the
        coefficients' own complex dtype (complex128 stays complex128)."""
        if not hasattr(self, "_rotate_fn"):
            self._rotate_fn = jax.jit(rotate_coeff)
        D = wigner_D_single(self.sht.l_max, *angles)
        coeff = jnp.asarray(coeff)
        return self._rotate_fn(coeff, jnp.asarray(D, dtype=coeff.dtype))

    def l2_distance(self, rho_a, rho_b):
        if not hasattr(self, "_l2_fn"):
            self._l2_fn = jax.jit(lambda a, b: jnp.sqrt(
                jnp.sum(self._w_int * jnp.abs(a - b) ** 2)
                / jnp.maximum(jnp.sum(self._w_int * jnp.abs(b) ** 2), 1e-30)
            ).astype(jnp.float32))
        return float(np.asarray(self._l2_fn(rho_a, rho_b)))

    def align(self, rho, ref_coeff, check_point_inversion=True):
        """Align rho to the reference: try the signal and its point inverse,
        keep the better rotation (reference alignment_routine :1089-1110).

        → (aligned rho, coeff, info dict)."""
        coeff = self.coefficients(rho)
        candidates = [("direct", coeff)]
        if check_point_inversion:
            candidates.append(("inverted", self.invert_parity(coeff)))
        best = None
        for tag, c in candidates:
            angles, score = self.find_rotation(ref_coeff, c)
            if best is None or score > best[0]:
                best = (score, tag, c, angles)
        score, tag, c, angles = best
        rot = self.rotate(c, angles)
        rho_rot = self._synth(rot)
        return rho_rot, rot, {"angles": angles, "score": score,
                              "inverted": tag == "inverted"}

    # ----------------------------------------------------------- batched path
    def _build_batch_fns(self):
        if hasattr(self, "_batch_scores"):
            return
        self._batch_center = jax.jit(jax.vmap(self._center_fn))
        q_cart = np.asarray(self._q_cart, dtype=np.float32)

        @jax.jit
        def _psi_shift(psis, coms):
            # shifting ρ by −com multiplies its reciprocal amplitude by
            # e^{i q·com} — the same ramp _center applies to ft.forward(ρ)
            phase = jnp.exp(1j * jnp.einsum(
                "rtpc,nc->nrtp", jnp.asarray(q_cart), coms,
                precision="highest").astype(psis.dtype))
            return psis * phase

        self._batch_psi_shift = _psi_shift
        self._batch_coeffs = jax.jit(jax.vmap(self.sht.forward))
        par_t = np.asarray(self._parity[: self.l_align + 1], dtype=np.float32)

        @jax.jit
        def _scores(ref_t, cand_t):
            """Correlate every candidate (and its point inverse) against the
            reference in ONE call → per-candidate (max score, argmax)."""
            both = jnp.concatenate([cand_t, cand_t * par_t[None, None, None, :]],
                                   axis=0)

            def one(c):
                C = self.corr.correlate(ref_t, c, radial_weights=self._w_r)
                flat = C.reshape(-1)
                k = jnp.argmax(flat)
                return flat[k], k

            return jax.vmap(one)(both)

        self._batch_scores = _scores

        @jax.jit
        def _rotate_synth(coeffs, D, par):
            c = coeffs * par[:, None, None, :]
            rot = jnp.einsum("nlmk,nrkl->nrml", D.astype(coeffs.dtype), c,
                             precision=jax.lax.Precision.HIGHEST)
            return jax.vmap(self.sht.inverse)(rot)

        self._batch_rotate_synth = _rotate_synth

        @jax.jit
        def _l2(rhos, ref):
            den = jnp.maximum(jnp.sum(self._w_int * jnp.abs(ref) ** 2), 1e-30)

            def one(a):
                return jnp.sqrt(jnp.sum(self._w_int * jnp.abs(a - ref) ** 2)
                                / den).astype(jnp.float32)

            return jax.vmap(one)(rhos)

        self._batch_l2 = _l2

    def center_batch(self, rhos, psis=None):
        """vmapped centering; companion reciprocal amplitudes get the same
        phase ramp. → (rho_centered, psi_centered|None, coms)."""
        self._build_batch_fns()
        rhos, n = self._shard_cands(rhos)
        rhos_c, coms = self._batch_center(rhos)
        psis_c = None
        if psis is not None:
            psis_p, _ = self._shard_cands(psis)
            psis_c = self._batch_psi_shift(psis_p, coms)[:n]
        return rhos_c[:n], psis_c, coms[:n]

    def align_batch(self, rhos, ref_coeff, ref_rho=None, psis=None,
                    check_point_inversion=True):
        """Batched alignment of N candidates with ONE correlation device call
        (replacing the per-candidate host round-trips of align(); VERDICT r2
        item 7). psis are companion reciprocal amplitudes rotated/inverted
        identically (they live on the same angular grid, so the same Wigner
        rotation applies shell-wise). With a mesh, the candidate axis is
        sharded over its devices (padded by wrap-around, trimmed on return).

        → (rho_rot (N,...), psi_rot|None, l2 (N,)|None, infos list)."""
        self._build_batch_fns()
        rhos, n = self._shard_cands(rhos)
        np_ = int(rhos.shape[0])           # padded candidate count
        coeffs = self._batch_coeffs(rhos)
        scores2, idx2 = self._batch_scores(
            self._truncate(jnp.asarray(ref_coeff)), self._truncate(coeffs))
        scores2, idx2 = np.asarray(scores2), np.asarray(idx2)
        if check_point_inversion:
            inverted = scores2[np_:] > scores2[:np_]
            scores = np.where(inverted, scores2[np_:], scores2[:np_])
            idx = np.where(inverted, idx2[np_:], idx2[:np_])
        else:
            inverted = np.zeros(np_, dtype=bool)
            scores, idx = scores2[:np_], idx2[:np_]
        shape = (len(self.corr.alphas), len(self.corr.betas),
                 len(self.corr.gammas))
        ia, ib, ig = np.unravel_index(idx.astype(int), shape)
        angles = np.stack([self.corr.alphas[ia], self.corr.betas[ib],
                           self.corr.gammas[ig]], axis=1)
        # D at the coefficients' complex dtype (complex128 stays exact)
        D = jnp.asarray(np.stack([wigner_D_single(self.sht.l_max, *a)
                                  for a in angles]), dtype=coeffs.dtype)
        par = np.where(inverted[:, None], self._parity[None, :],
                       1.0).astype(np.float32)
        rho_rot = self._batch_rotate_synth(coeffs, D, par)
        psi_rot = None
        if psis is not None:
            psis_p, _ = self._shard_cands(psis)
            psi_coeffs = self._batch_coeffs(psis_p)
            psi_rot = self._batch_rotate_synth(psi_coeffs, D, par)[:n]
        l2 = None
        if ref_rho is not None:
            l2 = np.asarray(np.asarray(self._batch_l2(
                rho_rot, jnp.asarray(ref_rho))))[:n]
        infos = [{"angles": tuple(angles[i]), "score": float(scores[i]),
                  "inverted": bool(inverted[i])} for i in range(n)]
        return rho_rot[:n], psi_rot, l2, infos


class Aligner2D(_CandidateSharding):
    """Polar (2D) alignment: rotation search is a 1D circular correlation of
    the circular-harmonic coefficients (reference average 2D branch):
    C(α) = Σ_{r,m} w_r f_m(r) conj(g_m(r)) e^{imα}, point inversion is the
    parity flip f_m → (-1)^m f_m."""

    def __init__(self, ft, integration_weights, r_limit_ids=None,
                 real_dtype=jnp.float32, mesh=None):
        self.ft = ft
        self._init_mesh(mesh)
        self.n_phi = ft.n_phi
        n_r = ft.n_radial_points
        if r_limit_ids is None:
            r_limit_ids = np.arange(n_r)
        w = np.zeros(n_r)
        ids = np.asarray(r_limit_ids, dtype=int)
        w[ids] = np.asarray(ft.rs)[ids]
        self._w_r = (w / max(w.sum(), 1e-30)).astype(np.float32)
        self._w_int = np.asarray(integration_weights)
        ms = np.fft.fftfreq(self.n_phi, 1 / self.n_phi).astype(np.float32)
        self._parity = ((-1.0) ** np.abs(ms)).astype(np.float32)
        self.alphas = 2 * np.pi * np.arange(self.n_phi) / self.n_phi

        self._coeffs = jax.jit(lambda rho: jnp.fft.fft(rho, axis=-1)
                               / self.n_phi)
        self._ft_fwd = jax.jit(ft.forward)
        self._ft_inv = jax.jit(ft.inverse)

        @jax.jit
        def _correlate(f, g):
            M = jnp.einsum("r,rm,rm->m", self._w_r, f, g.conj(),
                           precision="highest")
            return jnp.fft.ifft(M).real * self.n_phi  # C(α_k), α_k = 2πk/n

        self._correlate = _correlate

        @jax.jit
        def _center(rho):
            w = jnp.abs(rho) * self._w_int
            total = jnp.sum(w)
            r_cart = self._r_cart()
            com = jnp.einsum("rp,rpc->c", w, jnp.asarray(r_cart),
                             precision="highest") / total
            psi = ft.forward(rho)
            q_cart = self._q_cart()
            phase = jnp.exp(1j * jnp.einsum(
                "rpc,c->rp", jnp.asarray(q_cart), com,
                precision="highest").astype(psi.dtype))
            return ft.inverse(psi * phase), com

        self._center_fn = _center

    def _r_cart(self):
        if not hasattr(self, "_r_cart_cache"):
            from xframe_tpu.library.shapes import polar_grid, spherical_to_cartesian
            phis = 2 * np.pi * np.arange(self.n_phi) / self.n_phi
            self._r_cart_cache = spherical_to_cartesian(
                polar_grid(np.asarray(self.ft.rs), phis))
        return self._r_cart_cache

    def _q_cart(self):
        if not hasattr(self, "_q_cart_cache"):
            from xframe_tpu.library.shapes import polar_grid, spherical_to_cartesian
            phis = 2 * np.pi * np.arange(self.n_phi) / self.n_phi
            self._q_cart_cache = spherical_to_cartesian(
                polar_grid(np.asarray(self.ft.qs), phis))
        return self._q_cart_cache

    def center(self, rho):
        return self._center_fn(rho)

    def coefficients(self, rho):
        return self._coeffs(rho)

    def invert_parity(self, coeff):
        if not hasattr(self, "_parity_fn"):
            self._parity_fn = jax.jit(lambda c: c * self._parity[None, :])
        return self._parity_fn(coeff)

    def rotate_density(self, rho, alpha):
        """Rotate by circular spectral shift: f(φ-α)."""
        if not hasattr(self, "_rotate_fn"):
            ms = np.fft.fftfreq(self.n_phi, 1 / self.n_phi).astype(np.float32)
            self._rotate_fn = jax.jit(lambda r, a: jnp.fft.ifft(
                jnp.fft.fft(r, axis=-1)
                * jnp.exp(-1j * ms * a).astype(r.dtype), axis=-1))
        return self._rotate_fn(rho, jnp.float32(alpha))

    def l2_distance(self, rho_a, rho_b):
        if not hasattr(self, "_l2_fn"):
            self._l2_fn = jax.jit(lambda a, b: jnp.sqrt(
                jnp.sum(self._w_int * jnp.abs(a - b) ** 2)
                / jnp.maximum(jnp.sum(self._w_int * jnp.abs(b) ** 2), 1e-30)
            ).astype(jnp.float32))
        return float(np.asarray(self._l2_fn(rho_a, rho_b)))

    def align(self, rho, ref_coeff, check_point_inversion=True):
        """2D point inversion ρ(-x) = ρ(r, φ+π) is itself a rotation, so the
        circular search covers it; no separate disambiguation branch."""
        coeff = self.coefficients(rho)
        C = np.asarray(self._correlate(ref_coeff, coeff))
        k = int(np.argmax(C))
        alpha = 2 * np.pi * k / self.n_phi
        rho_rot = self.rotate_density(rho, alpha)
        return rho_rot, None, {"angles": (alpha, 0.0, 0.0),
                               "score": float(C[k]), "inverted": False}

    # ----------------------------------------------------------- batched path
    def _build_batch_fns(self):
        if hasattr(self, "_batch_align"):
            return
        self._batch_center = jax.jit(jax.vmap(self._center_fn))
        q_cart = np.asarray(self._q_cart(), dtype=np.float32)

        @jax.jit
        def _psi_shift(psis, coms):
            phase = jnp.exp(1j * jnp.einsum(
                "rpc,nc->nrp", jnp.asarray(q_cart), coms,
                precision="highest").astype(psis.dtype))
            return psis * phase

        self._batch_psi_shift = _psi_shift
        n = self.n_phi

        def rot_one(r, k):
            idx = (jnp.arange(n) - k) % n         # f(φ−α), α = 2πk/n
            return r[..., idx]

        @jax.jit
        def _align(rhos, ref_coeff):
            coeffs = jnp.fft.fft(rhos, axis=-1) / n

            def score_one(c):
                M = jnp.einsum("r,rm,rm->m", self._w_r, ref_coeff, c.conj(),
                               precision="highest")
                Ca = jnp.fft.ifft(M).real * n
                k = jnp.argmax(Ca)
                return Ca[k], k

            scores, ks = jax.vmap(score_one)(coeffs)
            return scores, ks, jax.vmap(rot_one)(rhos, ks)

        # psi rotation and the l2-vs-reference column are separate jits so
        # callers without psis / ref_rho don't pay for dummy rotations and
        # discarded reductions
        self._batch_align = _align
        self._batch_rot = jax.jit(jax.vmap(rot_one))

        @jax.jit
        def _l2(rho_rot, ref_rho):
            den = jnp.maximum(jnp.sum(self._w_int * jnp.abs(ref_rho) ** 2),
                              1e-30)
            return jax.vmap(lambda a: jnp.sqrt(
                jnp.sum(self._w_int * jnp.abs(a - ref_rho) ** 2) / den)
            )(rho_rot).astype(jnp.float32)

        self._batch_l2 = _l2

    def center_batch(self, rhos, psis=None):
        self._build_batch_fns()
        rhos, n = self._shard_cands(rhos)
        rhos_c, coms = self._batch_center(rhos)
        psis_c = None
        if psis is not None:
            psis_p, _ = self._shard_cands(psis)
            psis_c = self._batch_psi_shift(psis_p, coms)[:n]
        return rhos_c[:n], psis_c, coms[:n]

    def align_batch(self, rhos, ref_coeff, ref_rho=None, psis=None,
                    check_point_inversion=True):
        """One-call batched circular alignment; companion psis get the same
        spectral rotation. → (rho_rot, psi_rot|None, l2|None, infos)."""
        self._build_batch_fns()
        rhos, n = self._shard_cands(rhos)
        scores, ks, rho_rot = self._batch_align(rhos, jnp.asarray(ref_coeff))
        psi_rot = None
        if psis is not None:
            psis_p, _ = self._shard_cands(psis)
            psi_rot = self._batch_rot(psis_p, ks)[:n]
        l2 = None if ref_rho is None \
            else np.asarray(np.asarray(self._batch_l2(
                rho_rot, jnp.asarray(ref_rho))))[:n]
        scores, ks = np.asarray(scores)[:n], np.asarray(ks)[:n]
        infos = [{"angles": (2 * np.pi * int(k) / self.n_phi, 0.0, 0.0),
                  "score": float(s), "inverted": False}
                 for s, k in zip(scores, ks)]
        return rho_rot[:n], psi_rot, l2, infos
