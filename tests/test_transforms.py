"""Numerical unit tests for the transform stack (SHT, Hankel, composed FT).

These are the accuracy tests the reference lacks in its live suite
(SURVEY.md §4): band-limited SHT round-trips, analytic-function Fourier
transforms, and quadrature-mode consistency.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from xframe_tpu.ops.sht import SphericalHarmonicTransform, CircularHarmonicTransform
from xframe_tpu.ops.fourier import SphericalFourierTransform, PolarFourierTransform
from xframe_tpu.ops.integrate import SphericalIntegrator


@pytest.fixture(scope="module", autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


class TestSHT:
    def test_roundtrip_bandlimited(self):
        L = 16
        sht = SphericalHarmonicTransform(L, real_dtype=jnp.float64)
        rng = np.random.default_rng(0)
        c = rng.normal(size=(3, sht.n_m, L + 1)) + 1j * rng.normal(size=(3, sht.n_m, L + 1))
        c *= np.asarray(sht.lm_mask)
        c2 = sht.forward(sht.inverse(jnp.asarray(c)))
        assert float(jnp.abs(c2 - c).max()) < 1e-11

    def test_constant_function_Y00(self):
        sht = SphericalHarmonicTransform(8, real_dtype=jnp.float64)
        f = jnp.ones((1, sht.n_theta, sht.n_phi), dtype=jnp.complex128)
        c = sht.forward(f)
        L = sht.l_max
        assert abs(complex(c[0, L, 0]) - 2 * np.sqrt(np.pi)) < 1e-12
        c_rest = np.asarray(c).copy()
        c_rest[0, L, 0] = 0
        assert np.abs(c_rest).max() < 1e-12

    def test_parseval(self):
        L = 12
        sht = SphericalHarmonicTransform(L, real_dtype=jnp.float64)
        rng = np.random.default_rng(1)
        c = rng.normal(size=(1, sht.n_m, L + 1)) + 1j * rng.normal(size=(1, sht.n_m, L + 1))
        c *= np.asarray(sht.lm_mask)
        f = sht.inverse(jnp.asarray(c))
        # ∫|f|²dΩ = Σ|c|²  (orthonormal basis); quadrature: GL in θ, uniform φ
        w = sht.gl_weights
        quad = float(jnp.sum(jnp.abs(f[0]) ** 2 * w[:, None]) * 2 * np.pi / sht.n_phi)
        assert abs(quad - float(np.sum(np.abs(c) ** 2))) / quad < 1e-12

    def test_grid_rule_matches_reference(self):
        # shtns_plugin.py:94-101 for L=64, anti-aliasing degree 2
        sht = SphericalHarmonicTransform(64)
        assert sht.n_phi == 256 and sht.n_theta == 128


class TestFourier3D:
    @pytest.mark.parametrize("mode,rc", [("midpoint", 2.0), ("midpoint", np.pi),
                                         ("gauss", 2.0)])
    def test_gaussian_analytic(self, mode, rc):
        N, L = 64, 8
        ft = SphericalFourierTransform(N, L, q_max=0.5, mode=mode,
                                       reciprocity_coefficient=rc,
                                       real_dtype=jnp.float64)
        sigma = ft.r_max / 6
        prof = np.exp(-ft.rs ** 2 / (2 * sigma ** 2))
        rho = jnp.asarray(np.broadcast_to(prof[:, None, None],
                          (N, ft.sht.n_theta, ft.sht.n_phi)), dtype=jnp.complex128)
        psi = ft.forward(rho)
        ana = sigma ** 3 * np.exp(-(sigma ** 2) * ft.qs ** 2 / 2)
        num = np.asarray(psi[:, 0, 0]).real
        assert np.abs(num - ana).max() / ana.max() < 1e-5

    def test_roundtrip(self):
        # smooth, band-limited density: gaussian radial profiles on low-l coeffs
        N, L = 32, 8
        ft = SphericalFourierTransform(N, L, q_max=0.5, mode="midpoint",
                                       reciprocity_coefficient=2.0,
                                       real_dtype=jnp.float64)
        sht = ft.sht
        rng = np.random.default_rng(2)
        sigma = ft.r_max / 6
        prof = np.exp(-ft.rs ** 2 / (2 * sigma ** 2))
        c = np.zeros((N, sht.n_m, L + 1), dtype=complex)
        # physically smooth densities have f_lm(r) ~ r^l near the origin
        for (m, l) in [(0, 0), (1, 2), (-2, 3)]:  # centered layout: j = m + L
            c[:, m + L, l] = ft.rs ** l * prof * (rng.normal() + 1j * rng.normal())
        rho = sht.inverse(jnp.asarray(c))
        rho_rt = ft.inverse(ft.forward(rho))
        rel = float(jnp.abs(rho_rt - rho).max() / jnp.abs(rho).max())
        assert rel < 1e-4

    def test_trapz_mode_runs(self):
        N, L = 24, 4
        ft = SphericalFourierTransform(N, L, q_max=0.5, mode="trapz",
                                       reciprocity_coefficient=np.pi,
                                       real_dtype=jnp.float64)
        rho = jnp.ones((N, ft.sht.n_theta, ft.sht.n_phi), dtype=jnp.complex128)
        psi = ft.forward(rho)
        assert psi.shape == rho.shape and np.isfinite(np.asarray(psi)).all()


class TestSphericalBesselAllOrders:
    def test_matches_scipy_everywhere(self):
        """spherical_jn_all (shared-recurrence j_l, the cold-start weight
        builder) vs scipy's per-(l,z) ufunc: absolute agreement at the
        1e-13·column-max level across the zero/tiny/turning-point/
        oscillatory regimes both recurrence branches cover."""
        from scipy.special import spherical_jn
        from xframe_tpu.ops.hankel import spherical_jn_all
        rng = np.random.default_rng(7)
        z = np.concatenate([
            np.array([0.0, 1e-12, 1e-6, 1e-3, 0.5, np.pi, 2 * np.pi]),
            rng.uniform(0.0, 140.0, 400),      # Miller downward branch
            rng.uniform(140.0, 2500.0, 400),   # upward branch
        ])
        for L in (0, 1, 5, 64, 128):
            got = spherical_jn_all(L, z)
            ref = spherical_jn(np.arange(L + 1)[:, None], z[None, :])
            colmax = np.maximum(np.abs(ref).max(axis=0), 1e-300)
            assert np.abs(got - ref).max(axis=0).max() < 1e-13 * colmax.max()
            assert (np.abs(got - ref).max(axis=0) < 1e-12 * colmax).all()

    def test_weight_tables_unchanged(self):
        """The assembled midpoint weight tables equal a direct scipy build
        (regression for the recurrence swap in _spherical_weights)."""
        from scipy.special import spherical_jn
        from xframe_tpu.ops.hankel import _spherical_weights
        N, L, rc = 48, 12, np.pi
        w, _ = _spherical_weights("midpoint", L, N, rc)
        ps = np.arange(N) + 0.5
        ks = np.arange(N) + 0.5
        arg = ks[None, :] * ps[:, None] * rc / N
        ref = ps[None, :, None] ** 2 * spherical_jn(
            np.arange(L + 1)[:, None, None], arg[None])
        assert np.abs(w - ref).max() < 1e-12 * np.abs(ref).max()


class TestFourier2D:
    def test_gaussian_analytic(self):
        N, M = 64, 8
        ft = PolarFourierTransform(N, M, n_phi=32, q_max=0.5, mode="midpoint",
                                   reciprocity_coefficient=2.0, real_dtype=jnp.float64)
        sigma = ft.r_max / 6
        prof = np.exp(-ft.rs ** 2 / (2 * sigma ** 2))
        rho = jnp.asarray(np.broadcast_to(prof[:, None], (N, 32)), dtype=jnp.complex128)
        psi = ft.forward(rho)
        # 2D FT with 1/(2π) convention: σ² exp(-σ²q²/2)
        ana = sigma ** 2 * np.exp(-(sigma ** 2) * ft.qs ** 2 / 2)
        num = np.asarray(psi[:, 0]).real
        assert np.abs(num - ana).max() / ana.max() < 1e-3


class TestIntegrate:
    def test_sphere_volume(self):
        N = 128
        rs = np.linspace(0.5 / N, 1 - 0.5 / N, N)
        integ = SphericalIntegrator(rs, 16, 32, real_dtype=jnp.float64)
        one = jnp.ones((N, 16, 32))
        vol = float(integ.integrate(one))
        assert abs(vol - 4 / 3 * np.pi * rs.max() ** 3) / vol < 5e-3


class TestCircular:
    def test_roundtrip(self):
        cht = CircularHarmonicTransform(32, real_dtype=jnp.float64)
        rng = np.random.default_rng(3)
        f = jnp.asarray(rng.normal(size=(5, 32)) + 1j * rng.normal(size=(5, 32)))
        f2 = cht.inverse(cht.forward(f))
        assert float(jnp.abs(f2 - f).max()) < 1e-12


class TestZernikeMode:
    def test_zernike_radial_polynomials(self):
        from xframe_tpu.ops.hankel import zernike_radial
        x = np.linspace(0.01, 0.99, 17)
        # R^0_0 = 1
        assert np.allclose(zernike_radial(0, [0], x, 3), 1.0)
        # closure at x=1: R^l_s(1) = 1 for the jacobi P(a,0) normalization
        for dim in (2, 3):
            for l, s in [(0, 2), (1, 3), (2, 6)]:
                val = zernike_radial(l, [s], np.array([1.0]), dim)
                assert np.allclose(np.abs(val), 1.0, atol=1e-12)

    def test_zernike_gaussian_analytic_3d(self):
        N, L = 64, 6
        ft = SphericalFourierTransform(N, L, q_max=0.5, mode="Zernike",
                                       reciprocity_coefficient=np.pi,
                                       real_dtype=jnp.float64)
        sigma = ft.r_max / 6
        prof = np.exp(-ft.rs ** 2 / (2 * sigma ** 2))
        rho = jnp.asarray(np.broadcast_to(prof[:, None, None],
                          (N, ft.sht.n_theta, ft.sht.n_phi)),
                          dtype=jnp.complex128)
        psi = ft.forward(rho)
        ana = sigma ** 3 * np.exp(-(sigma ** 2) * ft.qs ** 2 / 2)
        num = np.asarray(psi[:, 0, 0]).real
        assert np.abs(num - ana).max() / ana.max() < 5e-3

    def test_zernike_roundtrip_3d(self):
        N, L = 32, 4
        ft = SphericalFourierTransform(N, L, q_max=0.5, mode="Zernike",
                                       reciprocity_coefficient=np.pi,
                                       real_dtype=jnp.float64)
        sht = ft.sht
        rng = np.random.default_rng(3)
        sigma = ft.r_max / 6
        prof = np.exp(-ft.rs ** 2 / (2 * sigma ** 2))
        c = np.zeros((N, sht.n_m, L + 1), dtype=complex)
        for (m, l) in [(0, 0), (1, 2)]:
            c[:, m + L, l] = ft.rs ** l * prof * (rng.normal() + 1j * rng.normal())
        rho = sht.inverse(jnp.asarray(c))
        rho_rt = ft.inverse(ft.forward(rho))
        # r=0 sample is not reconstructed by the Zernike quadrature
        rel = float(jnp.abs(rho_rt[1:] - rho[1:]).max() / jnp.abs(rho).max())
        assert rel < 5e-3

    def test_zernike_gaussian_analytic_2d(self):
        N, M = 64, 4
        ft = PolarFourierTransform(N, M, n_phi=32, q_max=0.5, mode="Zernike",
                                   reciprocity_coefficient=np.pi,
                                   real_dtype=jnp.float64)
        sigma = ft.r_max / 6
        prof = np.exp(-ft.rs ** 2 / (2 * sigma ** 2))
        rho = jnp.asarray(np.broadcast_to(prof[:, None], (N, 32)),
                          dtype=jnp.complex128)
        psi = ft.forward(rho)
        ana = sigma ** 2 * np.exp(-(sigma ** 2) * ft.qs ** 2 / 2)
        num = np.asarray(psi[:, 0]).real
        assert np.abs(num - ana).max() / ana.max() < 5e-3


def test_hankel_f32_weight_assembly_production_dims():
    """VERDICT r4 #5 (part 1): the directly-f32-assembled Hankel weight
    tables at PRODUCTION dims (N_q=256, L=127) against f64 host assembly
    (reference weight contract: hankel_transforms.py:302-535). Covers both
    the table contents and the applied transform."""
    import sys
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from sht_accuracy import rel
    from xframe_tpu.ops.hankel import generate_weights, assemble_weights
    nq, L = 256, 127
    wd = generate_weights(L, nq, np.pi, 3, 'midpoint')
    raw = np.asarray(wd['weights'])
    w64 = assemble_weights(raw, 1.7, np.pi, 3, 'midpoint',
                           dtype=np.complex128)
    w32 = assemble_weights(raw, 1.7, np.pi, 3, 'midpoint',
                           dtype=np.complex64)
    # measured 2026-08-20: fwd 4.6e-8, inv 3.6e-8 — pinned at ~4x margin
    assert rel(w32['forward'].astype(np.complex128), w64['forward']) < 2e-7
    assert rel(w32['inverse'].astype(np.complex128), w64['inverse']) < 2e-7
    # applied error on band-limited coefficients (reduced m: the Hankel
    # contraction is independent per m — radial/order dims stay production)
    rng = np.random.default_rng(4)
    c0 = (rng.standard_normal((nq, 16, L + 1))
          + 1j * rng.standard_normal((nq, 16, L + 1)))
    a64 = np.einsum('kpl,kml->pml', w64['forward'], c0, optimize=True)
    a32 = np.einsum('kpl,kml->pml', w32['forward'],
                    c0.astype(np.complex64), optimize=True)
    # measured 1.9e-7 — pinned at ~3x margin
    assert rel(a32.astype(np.complex128), a64) < 6e-7


def test_composed_ft_accuracy_production_shape():
    """VERDICT r4 #5 (part 2): the FULL composed FT = iSHT∘Hankel∘SHT at the
    production shape (N_q=256, L=127, 320×640) — f32 jnp path with
    f32-assembled weights vs a float64 host composition. Band-limit
    identities keep the host side affordable (SHT∘iSHT is exact on
    band-limited coefficients, so the host analysis steps are skipped), and
    only a radial subset of the per-shell syntheses is materialized in f64
    (the Hankel still mixes all 256 radial nodes).

    Measured 2026-08-20: fwd 3.2e-7, roundtrip 7.1e-7 vs f64 — no f32
    accuracy cliff in the COMPOSED transform at production scale (the f64
    quadrature round-trip defect on white coefficients is 0.41; the f32 one
    matches it to 7 digits). Pinned at ~3x margin."""
    import sys
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from sht_accuracy import HostSHT64, rel
    from xframe_tpu.ops.fourier import SphericalFourierTransform
    from xframe_tpu.ops.hankel import generate_weights, assemble_weights
    nq, L, nt, nph = 256, 127, 320, 640
    ft = SphericalFourierTransform(nq, L, n_theta=nt, n_phi=nph,
                                   mode='midpoint')
    ref = HostSHT64(L, nt, nph)
    rng = np.random.default_rng(3)
    c0 = (rng.standard_normal((nq, 2 * L + 1, L + 1))
          + 1j * rng.standard_normal((nq, 2 * L + 1, L + 1))) * ref.mask
    rho64 = ref.inverse(c0)
    wd = generate_weights(L, nq, np.pi, 3, 'midpoint')
    w64 = assemble_weights(np.asarray(wd['weights']), ft.r_max, np.pi, 3,
                           'midpoint', dtype=np.complex128)
    cf64 = np.einsum('kpl,kml->pml', w64['forward'], c0, optimize=True)
    cr64 = np.einsum('kpl,kml->pml', w64['inverse'], cf64, optimize=True)
    sel = np.arange(0, nq, 8)            # 32 of 256 shells in f64
    psi64 = ref.inverse(cf64[sel])
    rt64 = ref.inverse(cr64[sel])

    rho32 = jnp.asarray(rho64.astype(np.complex64))
    psi32, rt32 = jax.jit(ft.forward_and_roundtrip)(rho32)
    psi32 = np.asarray(psi32)[sel]
    rt32 = np.asarray(rt32)[sel]
    assert rel(psi32.astype(np.complex128), psi64) < 1e-6
    assert rel(rt32.astype(np.complex128), rt64) < 2e-6
    # f32 tracks the f64 quadrature defect, not adds to it
    d64 = rel(rt64, rho64[sel])
    d32 = rel(rt32.astype(np.complex128), rho64[sel])
    assert abs(d32 - d64) < 1e-5


# ------------------- jnp SHT accuracy vs order against a float64 reference
_SHT_CASES = [(16, 64, 128, 3e-7), (64, 256, 512, 3e-7),
              (127, 320, 640, 4e-7), (128, 320, 640, 4e-7)]


@pytest.fixture(scope="module")
def _sht_errors():
    """measure() per case, computed once: the float32 jnp SHT forward /
    inverse / round trip against scripts/sht_accuracy.HostSHT64 (float64)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from sht_accuracy import measure
    cache = {}

    def get(L, nt, nph):
        if (L, nt, nph) not in cache:
            cache[(L, nt, nph)] = measure(L, nt, nph, n_q=3, seed=1)
        return cache[(L, nt, nph)]
    return get


@pytest.mark.parametrize("kind", ["forward", "inverse", "roundtrip"])
@pytest.mark.parametrize("L,nt,nph,tol", _SHT_CASES)
def test_jnp_sht_accuracy_vs_order(_sht_errors, L, nt, nph, tol, kind):
    """float32 jnp SHT error on white band-limited coefficients against the
    float64 host reference, on the production θ grids up to L=128 (reference
    transform contract: shtns_plugin.py:94-135 computes in f64). Measured on
    the CPU: 0.6–1.4e-7 at every order — no accuracy cliff up to the
    production order; pinned at ~3x margin."""
    err = _sht_errors(L, nt, nph)
    assert err["sanity_f64"] < 1e-10           # the reference itself
    assert err[kind] < tol, (kind, err[kind])
