"""Tests for prephasing, cross-dataset unitary extraction, and
particle-number estimation."""
import numpy as np
import jax.numpy as jnp
import pytest

from xframe_tpu.ops.sht import SphericalHarmonicTransform
from xframe_tpu.projects.fxs import invariants as itools
from xframe_tpu.projects.fxs.demo import make_demo_problem


@pytest.fixture(scope="module")
def problem():
    return make_demo_problem(24, 10)


def _negativity(proj, sht):
    V = itools.pad_projection_matrices(proj, sht.l_max,
                                       np.atleast_2d(proj[0]).shape[0])
    I = np.asarray(sht.inverse(jnp.asarray(V))).real
    return float(np.abs(I[I < 0]).sum() / np.abs(I).sum())


def test_in_loop_particle_estimate_matches_bruteforce():
    """ReciprocalConstraint.particle_number_estimate's one-histogram trick
    must reproduce the reference's explicit (K × grid) negative-fraction scan
    (fxs_Projections.py:1115-1196) exactly, including the projected output."""
    import jax
    from xframe_tpu.projects.fxs.projections import ReciprocalConstraint
    rng = np.random.default_rng(3)
    n_q, L = 12, 4
    qs = np.linspace(0.05, 0.5, n_q)
    avg = np.abs(rng.normal(2.0, 0.5, n_q))
    proj = [rng.normal(size=(n_q, min(2 * l + 1, n_q)))
            + 1j * rng.normal(size=(n_q, min(2 * l + 1, n_q)))
            for l in range(L + 1)]
    rc = ReciprocalConstraint.build(
        proj, qs, L, average_intensity=avg, schmidt_scaling=False,
        pn_scan_space=(1.0, 16.0, 48), pn_project=True)
    assert rc.pn_enabled
    I = rng.normal(0.3, 1.0, (n_q, 6, 10)).astype(np.float32)
    n_hat, I_out = jax.jit(rc.particle_number_estimate)(jnp.asarray(I))

    # brute force (reference semantics)
    a = avg[:, None, None] / 1.0  # pn_a = avg (I00·Y00 with I00 = avg·2√π)
    sq = np.linspace(1.0, 4.0, 48)
    s = 1.0 / sq - 1.0
    neg = np.array([(I + si * a < 0).mean() for si in s])
    grad = (neg[1:] - neg[:-1]) / (sq[1:] - sq[:-1])
    idx = int(np.argmax(grad))
    assert np.isclose(float(n_hat), sq[idx] ** 2, rtol=1e-5)
    expect = np.maximum(I + s[idx] * a, 0.0)
    assert np.allclose(np.asarray(I_out), expect, atol=1e-5)


def test_enforce_sht_constraint_reduces_negativity(problem):
    """Scramble each V_l by a random unitary (destroys intensity positivity —
    exactly the situation prephasing addresses), then check the constraint
    loop substantially reduces the negative intensity volume while staying in
    the V_l·U_l gauge orbit (B_l unchanged)."""
    sht = problem.ft.sht
    rng = np.random.default_rng(11)
    proj = []
    for l, v in enumerate(problem.projection_matrices):
        N = v.shape[1]
        U = np.linalg.qr(rng.normal(size=(N, N))
                         + 1j * rng.normal(size=(N, N)))[0]
        proj.append(v @ U)
    neg0 = _negativity(proj, sht)
    assert neg0 > 0.01  # scrambling produced real negativity
    out, converged = itools.enforce_sht_constraint(proj, sht, iterations=100)
    assert len(out) == len(proj)
    for l, v in enumerate(out):
        assert v.shape == proj[l].shape
        # gauge orbit preserved: B_l = V_l V_l† unchanged
        b_in = proj[l] @ proj[l].conj().T
        b_out = v @ v.conj().T
        assert np.abs(b_out - b_in).max() < 1e-3 * max(np.abs(b_in).max(), 1e-9)
    neg1 = _negativity(out, sht)
    assert neg1 < 0.5 * neg0, (neg0, neg1)


def test_unknown_unitary_transform_recovers_rotation():
    rng = np.random.default_rng(5)
    n_q = 20
    W_true, proj1, proj2, eig1, eig2, b21 = [], [], [], [], [], []
    L = 6
    for l in range(L + 1):
        N = min(2 * l + 1, n_q)
        # V with orthogonal columns: V†V = diag(e)
        A = rng.normal(size=(n_q, N)) + 1j * rng.normal(size=(n_q, N))
        Q, _ = np.linalg.qr(A)
        e = np.sort(rng.uniform(0.5, 2.0, N))[::-1]
        V1 = Q * np.sqrt(e)[None, :]
        A2 = rng.normal(size=(n_q, N)) + 1j * rng.normal(size=(n_q, N))
        Q2, _ = np.linalg.qr(A2)
        e2 = np.sort(rng.uniform(0.5, 2.0, N))[::-1]
        V2 = Q2 * np.sqrt(e2)[None, :]
        U = np.linalg.qr(rng.normal(size=(N, N))
                         + 1j * rng.normal(size=(N, N)))[0]
        W_true.append(U)
        proj1.append(V1)
        proj2.append(V2)
        eig1.append(e)
        eig2.append(e2)
        b21.append(V2 @ U @ V1.conj().T)
    b21 = np.asarray(b21)
    qs = np.linspace(0.1, 1.0, n_q)
    for method in ("procrustes", "direct"):
        W, errors = itools.calc_unknown_unitary_transform(
            proj1, eig1, proj2, eig2, b21, qs, method=method)
        for l in range(L + 1):
            recon = proj2[l] @ W[l] @ proj1[l].conj().T
            rel = np.abs(recon - b21[l]).max() / np.abs(b21[l]).max()
            assert rel < 1e-5, (method, l, rel)


def test_estimate_number_of_particles_scaling(problem):
    """The onset scale must grow as √n: n-particle data has B_0 → n²B_0 and
    B_{l>0} → nB_l (estimate ratios, not absolute calibration — the absolute
    onset carries a data-dependent gauge factor, as in the reference)."""
    bl = problem.bl
    estimates = {}
    for n in [1, 4, 9]:
        bl_n = bl.copy()
        bl_n[0] = n ** 2 * bl[0]
        bl_n[1:] = n * bl[1:]
        proj, eigs = itools.deg2_invariant_to_projection_matrices(bl_n)
        n_hat, grad, neg, scales = itools.estimate_number_of_particles(
            proj, problem.ft.sht, search_space=(0.25, 6.0, 256))
        assert np.isfinite(neg).all() and neg.max() > 0
        estimates[n] = n_hat
    assert abs(estimates[4] / estimates[1] - 4) < 0.5
    assert abs(estimates[9] / estimates[1] - 9) < 1.0


# --------------------------------------------------- CC modifications (round 3)
def test_binned_mean_cc_matches_reference_semantics():
    """binned_mean_cc reproduces the reference binned_mean
    (fxs_invariant_tools.py:308-332): masked bin averages on a
    2*max_order-bin grid, with the wrap-around bin rolled to the front."""
    rng = np.random.default_rng(5)
    n_q, n_phi, L = 4, 48, 6
    phis = 2 * np.pi * np.arange(n_phi) / n_phi
    cc = rng.normal(size=(n_q, n_q, n_phi))
    mask = rng.uniform(size=cc.shape) > 0.25
    new_cc, new_mask, new_phis = itools.binned_mean_cc(cc, mask, L, phis)
    n_bins = 2 * L
    assert new_cc.shape == (n_q, n_q, n_bins)
    assert np.allclose(new_phis, np.arange(n_bins) * 2 * np.pi / n_bins)
    # brute force: each output bin b averages unmasked cc at phis within
    # [b*step - step/2, b*step + step/2) (periodically)
    step = np.pi / L
    ids = ((phis + step / 2) // step).astype(int) % n_bins
    for b in range(n_bins):
        sel = ids == b
        cnt = mask[..., sel].sum(axis=-1)
        expect = np.where(cnt > 0,
                          (cc[..., sel] * mask[..., sel]).sum(axis=-1)
                          / np.maximum(cnt, 1), 0.0)
        assert np.allclose(new_cc[..., b], expect), b
        assert np.array_equal(new_mask[..., b], cnt > 0)


def test_zero_cc_harmonics():
    rng = np.random.default_rng(6)
    cc = rng.normal(size=(3, 3, 32))
    out = itools.zero_cc_harmonics(cc, max_order=5)
    f = np.fft.rfft(out, axis=-1)
    assert np.abs(f[..., 6:]).max() < 1e-10 * np.abs(f).max()
    assert np.allclose(np.fft.rfft(cc, axis=-1)[..., :6], f[..., :6])
    out_odd = itools.zero_cc_harmonics(cc, zero_odd=True)
    f_odd = np.fft.rfft(out_odd, axis=-1)
    assert np.abs(f_odd[..., 1::2]).max() < 1e-10 * np.abs(f_odd).max()
    # a pi-periodic signal is invariant under odd-harmonic removal
    per = np.tile(rng.normal(size=(3, 3, 16)), (1, 1, 2))
    assert np.allclose(itools.zero_cc_harmonics(per, zero_odd=True), per,
                       atol=1e-10)


def test_low_pass_cc_in_q_matches_scipy():
    from scipy.signal import butter, sosfilt
    rng = np.random.default_rng(7)
    cc = rng.normal(size=(16, 16, 8))
    cutoff = 3.0
    got = itools.low_pass_cc_in_q(cc, cutoff)
    sos = butter(1, cutoff, "lp", fs=16, output="sos")
    expected = sosfilt(sos, sosfilt(sos, cc, axis=0), axis=1)
    assert np.allclose(got, expected)


def test_line_q_id_limits_geometry():
    """Per-order line limits: each order's [lo, hi) follows the specified
    lines in (order, q) space; the 3D mask is the outer product of the row
    validity (reference calc_deg_2_invariant_line_mask, extract.py:368-414)."""
    n_q, L = 32, 10
    qs = np.linspace(0.0, 0.31, n_q)
    # min line from (order 0, q 0.0) to (order 10, q 0.2): lo grows with l
    min_line = ((0.0, 0.0), (10.0, 0.2))
    # max line from (order 0, q 0.15) to (order 10, q 0.31): hi grows with l
    max_line = ((0.0, 0.15), (10.0, 0.31))
    mask, lim = itools.line_q_id_limits(qs, L, min_line=min_line,
                                        max_line=max_line)
    assert lim.shape == (L + 1, 2)
    assert mask.shape == (L + 1, n_q, n_q)
    # analytic: q_min(l) = 0.02*l, q_max(l) = 0.15 + 0.016*l
    for l in range(L + 1):
        lo_expect = np.searchsorted(qs, 0.02 * l)
        hi_expect = np.searchsorted(qs, 0.15 + 0.016 * l, side="right")
        assert abs(int(lim[l, 0]) - lo_expect) <= 1, (l, lim[l], lo_expect)
        assert abs(int(lim[l, 1]) - hi_expect) <= 1, (l, lim[l], hi_expect)
        rows = np.zeros(n_q, dtype=bool)
        rows[lim[l, 0]:lim[l, 1]] = True
        assert np.array_equal(mask[l], rows[:, None] & rows[None, :])
    # monotonic in l for these lines
    assert (np.diff(lim[:, 0]) >= 0).all()
    assert (np.diff(lim[:, 1]) >= 0).all()


def test_apply_psd_on_q_limits_subblocks():
    """PSD projection acts only inside each order's q-limit sub-block;
    outside entries are untouched (reference apply_invariant_constraints)."""
    rng = np.random.default_rng(8)
    L, n_q = 3, 10
    bl = rng.normal(size=(L + 1, n_q, n_q))
    bl = bl + np.swapaxes(bl, 1, 2)  # symmetric but indefinite
    lim = np.array([[0, n_q], [2, 8], [3, 6], [9, 9]])
    out = itools.apply_psd_on_q_limits(bl, lim)
    for l, (lo, hi) in enumerate(lim):
        if hi > lo:
            ev = np.linalg.eigvalsh(out[l, lo:hi, lo:hi])
            assert ev.min() > -1e-10, (l, ev.min())
        outside = np.ones((n_q, n_q), dtype=bool)
        outside[lo:hi, lo:hi] = False
        assert np.array_equal(out[l][outside], bl[l][outside]), l
    # order 3 has an empty block: fully untouched
    assert np.array_equal(out[3], bl[3])


def test_extract_with_line_limits_changes_projection_support(tmp_path,
                                                             monkeypatch):
    """End-to-end: line bl_q_limits restrict each order's V_l support to its
    q window, as the reference's sub-block eigendecomposition does."""
    import os
    import xframe_tpu as xf
    from xframe_tpu.io import hdf5 as hdf5_io
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    rng = np.random.default_rng(9)
    n_q, L, n_phi = 16, 6, 64
    qs = np.linspace(0.02, 0.4, n_q)
    # synthetic CC from a random PSD B_l set
    bl = np.zeros((L + 1, n_q, n_q), dtype=complex)
    for l in range(0, L + 1, 2):
        v = rng.normal(size=(n_q, 2 * l + 1))
        bl[l] = v @ v.T
    cc = itools.deg2_invariant_to_cc_3d(bl, 1.23984, qs, n_phi)
    folder = os.path.join(str(tmp_path), "data", "fxs", "ccd", "line_test",
                          "run_1")
    os.makedirs(folder, exist_ok=True)
    hdf5_io.save(os.path.join(folder, "ccd.h5"), {
        "dimensions": 3, "radial_points": qs,
        "angular_points": 2 * np.pi * np.arange(n_phi) / n_phi,
        "xray_wavelength": 1.23984,
        "average_intensity": np.zeros(n_q),
        "cross_correlation": {"I1I1": cc.real},
        "num_images_processed": 1, "num_images_good": 1})

    overrides = {
        "structure_name": "line_test", "max_order": L,
        "cross_correlation": {
            "datasets": {"I1I1": {
                "modify_cc": {"subtract_average_intensity": False},
                "bl_q_limits": {
                    "min": {"type": "line",
                            "line": [[0, qs[3]], [L, qs[3]]]},
                    "max": {"type": "line",
                            "line": [[0, qs[12]], [L, qs[12]]]}}}}},
    }
    xf.select_project("fxs", "extract", overrides=overrides)
    inv = xf.run()
    qlim = np.asarray(inv["data_projection_matrices_q_id_limits"])
    assert (qlim[:, 0] >= 3).all() and (qlim[:, 1] <= 13).all()
    for l in range(0, L + 1, 2):
        V = np.asarray(inv["data_projection_matrices"]["I1I1"][l])
        lo, hi = qlim[l]
        assert np.abs(V[:lo]).max() == 0 if lo > 0 else True
        assert np.abs(V[hi:]).max() == 0 if hi < n_q else True
        assert np.abs(V[lo:hi]).max() > 0
    mask = np.asarray(inv["deg_2_invariant_masks"]["I1I1"])
    assert mask.shape == (L + 1, n_q, n_q)
    assert not mask[0, 0, 0] and mask[0, 5, 5]


def test_symmetrize_cc_q1q2_reference_semantics():
    """q1q2_symmetrize must average cc(q1,q2,Δ) with the Δ-REVERSED transpose
    cc(q2,q1,−Δ) under mask weights (reference fxs_invariant_tools.py:271-281)
    — not the plain transpose."""
    rng = np.random.default_rng(3)
    n_q, n_phi = 5, 8
    cc = rng.normal(size=(n_q, n_q, n_phi))
    mask = rng.random((n_q, n_q, n_phi)) > 0.3
    out, omask = itools.symmetrize_cc_q1q2(cc, mask)

    # reference-style numpy construction
    sw = cc.copy(); sw[..., 1:] = cc[..., 1:][..., ::-1]
    swm = mask.copy(); swm[..., 1:] = mask[..., 1:][..., ::-1]
    sw, swm = np.swapaxes(sw, 0, 1), np.swapaxes(swm, 0, 1)
    both = mask & swm
    only_a, only_b = mask & ~swm, swm & ~mask
    assert np.allclose(out[both], (cc[both] + sw[both]) / 2)
    assert np.allclose(out[only_a], cc[only_a])
    assert np.allclose(out[only_b], sw[only_b])
    assert (out[~(mask | swm)] == 0).all()
    assert (omask == (mask | swm)).all()

    # the symmetrized CC satisfies out(q1,q2,Δk) == out(q2,q1,Δ_{n−k})
    rev = out.copy(); rev[..., 1:] = out[..., 1:][..., ::-1]
    assert np.allclose(out, np.swapaxes(rev, 0, 1))

    # a Δ-odd component is NOT killed by the correct symmetrization when it
    # is q1q2-antisymmetric in the right way (plain-transpose averaging
    # zeroed it): build cc(q1,q2,Δ)=s(q1,q2)·sin(Δ) with s antisymmetric
    phis = 2 * np.pi * np.arange(n_phi) / n_phi
    s = rng.normal(size=(n_q, n_q)); s = s - s.T
    cc2 = s[:, :, None] * np.sin(phis)[None, None, :]
    full = np.ones_like(cc2, dtype=bool)
    out2, _ = itools.symmetrize_cc_q1q2(cc2, full)
    assert np.allclose(out2, cc2, atol=1e-12)  # already symmetric: unchanged
    plain = (cc2 + np.swapaxes(cc2, 0, 1)) / 2
    assert np.abs(plain).max() < 1e-12  # the old averaging destroyed it


def test_enforce_max_order_caps_below_low_pass_order(tmp_path, monkeypatch):
    """modify_cc: when both low_pass_order and enforce_max_order are set,
    the tighter cap wins — enforce_max_order zeroes every CC harmonic above
    the grid L (reference fxs_invariant_tools.py:254-260), so a looser
    low_pass_order must not resurrect them."""
    import os
    import xframe_tpu as xf
    from xframe_tpu.io import hdf5 as hdf5_io
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    rng = np.random.default_rng(5)
    n_q, L, n_phi = 12, 4, 64
    qs = np.linspace(0.02, 0.4, n_q)
    cc = rng.normal(size=(n_q, n_q, n_phi))  # broadband: harmonics at all n
    folder = os.path.join(str(tmp_path), "data", "fxs", "ccd", "cap_test",
                          "run_1")
    os.makedirs(folder, exist_ok=True)
    data = {"dimensions": 3, "radial_points": qs,
            "angular_points": 2 * np.pi * np.arange(n_phi) / n_phi,
            "xray_wavelength": 1.23984,
            "average_intensity": np.zeros(n_q),
            "cross_correlation": {"I1I1": cc},
            "num_images_processed": 1, "num_images_good": 1}
    hdf5_io.save(os.path.join(folder, "ccd.h5"), data)

    def run(modify):
        overrides = {"structure_name": "cap_test", "max_order": L,
                     "cross_correlation": {"datasets": {"I1I1": {
                         "modify_cc": dict(
                             subtract_average_intensity=False, **modify)}}}}
        xf.select_project("fxs", "extract", overrides=overrides)
        return xf.run()

    both = run({"low_pass_order": L + 40, "enforce_max_order": True})
    capped = run({"enforce_max_order": True})
    a = np.asarray(both["deg_2_invariant"]["I1I1"])
    b = np.asarray(capped["deg_2_invariant"]["I1I1"])
    assert np.allclose(a, b, atol=1e-10)
