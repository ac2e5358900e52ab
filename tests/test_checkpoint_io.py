"""Checkpoints and results leave the device exactly as computed.

Host transfers are plain np.asarray / jax.device_get: complex128, float64,
bool and wide integer arrays come back bit-exact (no detour through float32
planes), checkpoints round-trip complex64 and complex128 states, and a
checkpoint written by the former replay best tracking — best iterate held as
an anchor state plus a replay length — resumes on the plain path.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from xframe_tpu.io import hdf5 as hdf5_io
from xframe_tpu.parallel.mesh import CheckpointingRunner, MultiStartRunner
from xframe_tpu.projects.fxs.phasing import PhasingState, Segment


@pytest.fixture(scope="module")
def demo():
    from xframe_tpu.projects.fxs.demo import make_demo_problem
    return make_demo_problem(12, 6)


def _schedule(p):
    return [Segment("HIO", 4, betas=np.full(4, 0.5), ft_stab=True),
            Segment("SW", sigma=p.mtip.sw.default_sigma, threshold=0.1),
            Segment("ER", 3, betas=np.zeros(3), ft_stab=True)]


def test_replay_checkpoint_resumes_on_plain_path(demo, tmp_path):
    """A replay-era checkpoint (placeholder best_rho + anchor fields) loads
    with best_rho rebuilt by replaying anchor_len iterations from the anchor,
    matching the best iterate of the uninterrupted run, and the resumed run
    ends where the uninterrupted one does."""
    p = demo
    sched = _schedule(p)
    rho0s = p.initial_density_batch(4, 2)
    ck = str(tmp_path / "replay.h5")
    first = CheckpointingRunner(p.mtip, sched, checkpoint_path=ck)
    first(rho0s, resume=False, max_chunks=1)          # HIO×4 + SW lands
    d = hdf5_io.load(ck)
    errs = np.asarray(d["errors"])[:, :, 0]           # (2, 4)
    best_idx = errs.argmin(axis=1)
    true_best = np.asarray(d["best_rho_re"]) + 1j * np.asarray(d["best_rho_im"])
    # replay form: anchor = the restart's initial density (global iteration
    # 0), replay length = best index + 1; best_rho a stale placeholder
    r0 = np.asarray(rho0s)
    d.update(anchor_rho_re=r0.real, anchor_rho_im=r0.imag,
             anchor_sup=np.asarray(p.initial_support)[None].repeat(2, 0)
             .astype(np.int8),
             anchor_z_re=np.zeros(2), anchor_z_im=np.zeros(2),
             anchor_z2_re=np.zeros(2), anchor_z2_im=np.zeros(2),
             anchor_start=np.zeros(2, np.int32),
             anchor_len=(best_idx + 1).astype(np.int32),
             anchor_gate=np.ones(2, np.float32),
             best_rho_re=np.zeros_like(r0.real),
             best_rho_im=np.zeros_like(r0.real))
    hdf5_io.save(ck, d)
    second = CheckpointingRunner(p.mtip, sched, checkpoint_path=ck)
    state, start, _ = second._load()
    assert start == 1
    scale = np.abs(true_best).max()
    dev = np.abs(np.asarray(state.best_rho) - true_best).max() / scale
    # the replay runs each step as its own program, the original inside a
    # vmapped scan: rounding differs at 1e-7 and HIO amplifies it ~10x per
    # iteration (measured 1.1e-5 after up to 4 iterations)
    assert dev < 1e-4
    _, errors = second(rho0s, resume=True)
    _, ref = CheckpointingRunner(p.mtip, sched)(rho0s, resume=False)
    np.testing.assert_allclose(np.asarray(errors), np.asarray(ref),
                               rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("cdtype", ["complex64", "complex128"])
def test_checkpoint_roundtrip_complex_dtype(demo, tmp_path, cdtype):
    """save → load reproduces the batched state bit-exactly at the MTIP's
    own complex dtype."""
    p = demo
    mtip = p.mtip
    with jax.enable_x64(cdtype == "complex128"):
        saved = (mtip.cdtype, mtip.rdtype)
        mtip.cdtype = jnp.dtype(cdtype)
        mtip.rdtype = jnp.float64 if cdtype == "complex128" else jnp.float32
        try:
            rng = np.random.default_rng(0)
            shape = (2,) + np.shape(mtip.initial_support)
            rho = (rng.standard_normal(shape)
                   + 1j * rng.standard_normal(shape)).astype(cdtype)
            sup = rng.random(shape) > 0.5
            err = rng.random(2).astype(mtip.rdtype)
            state = PhasingState(rho=jnp.asarray(rho), support=jnp.asarray(sup),
                                 best_rho=jnp.asarray(rho[::-1]),
                                 best_mask=jnp.asarray(~sup),
                                 best_err=jnp.asarray(err),
                                 last_err=jnp.asarray(err[::-1]))
            runner = CheckpointingRunner(mtip, _schedule(p),
                                         checkpoint_path=str(tmp_path / "c.h5"))
            runner._save(state, [], 3)
            loaded, chunk, errors = runner._load()
        finally:
            mtip.cdtype, mtip.rdtype = saved
        assert chunk == 3 and errors == []
        assert np.asarray(loaded.rho).dtype == np.dtype(cdtype)
        np.testing.assert_array_equal(np.asarray(loaded.rho), rho)
        np.testing.assert_array_equal(np.asarray(loaded.best_rho), rho[::-1])
        np.testing.assert_array_equal(np.asarray(loaded.support), sup)
        np.testing.assert_array_equal(np.asarray(loaded.best_err), err)


# values a float32 detour would change
_EXACT = {
    "float64": np.array([1.0 + 2.0 ** -40, -3.0 - 2.0 ** -45]),
    "complex128": np.array([1.0 + 2.0 ** -40 + (2.0 - 2.0 ** -44) * 1j]),
    "int64": np.array([2 ** 24 + 1, 2 ** 40 + 3, -(2 ** 31) - 5]),
    "bool": np.array([True, False, True]),
}


@pytest.mark.parametrize("kind", sorted(_EXACT))
def test_checkpoint_save_is_bit_exact(demo, tmp_path, kind):
    """_save writes the device arrays themselves: every dtype reaches the
    file bit-exactly (the former float32-plane transfer rounded float64 and
    integers beyond 2**24)."""
    value = _EXACT[kind]
    with jax.enable_x64(True):
        dev = jnp.asarray(value)
        assert np.asarray(dev).dtype == value.dtype
        state = PhasingState(rho=jnp.asarray([1 + 0j]), support=dev,
                             best_rho=jnp.asarray([1 + 0j]), best_mask=dev,
                             best_err=dev, last_err=dev)
        runner = CheckpointingRunner(demo.mtip, _schedule(demo),
                                     checkpoint_path=str(tmp_path / "b.h5"))
        runner._save(state, [], 1)
    raw = hdf5_io.load(str(tmp_path / "b.h5"))
    for key in ("support", "best_mask", "best_err", "last_err"):
        got = np.asarray(raw[key])
        assert got.dtype == value.dtype, (key, got.dtype)
        np.testing.assert_array_equal(got, value)


def test_collect_results_bit_exact_float64(home_x64_results):
    """_collect_results under precision float64: densities stay complex128,
    error curves float64, masks bool — each equal to the device values."""
    res, states, errors, order, sqrt_s = home_x64_results
    r0 = res["reconstruction_results"]["0"]
    i = int(order[0])
    assert r0["real_density"].dtype == np.complex128
    np.testing.assert_array_equal(
        r0["real_density"], np.asarray(states.best_rho)[i] * sqrt_s)
    assert r0["error_dict"]["main"].dtype == np.float64
    np.testing.assert_array_equal(r0["error_dict"]["main"],
                                  np.asarray(errors)[i][:, 0])
    assert r0["support_mask"].dtype == bool
    np.testing.assert_array_equal(r0["support_mask"],
                                  np.asarray(states.best_mask)[i])


@pytest.fixture
def home_x64_results(tmp_path, monkeypatch):
    """Reconstruct-worker result collection on a float64 demo problem."""
    import xframe_tpu as xf
    from xframe_tpu.projects.fxs.demo import make_demo_problem
    from xframe_tpu.projects.fxs.reconstruct import ProjectWorker
    from xframe_tpu.parallel.mesh import rank_restarts
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    with jax.enable_x64(True):
        p = make_demo_problem(10, 4, real_dtype=jnp.float64)
        xf.select_project("fxs", "reconstruct", "tutorial", overrides={
            "structure_name": "x64", "precision": "float64"})
        w = ProjectWorker()
        sched = _schedule(p)
        states, errors = MultiStartRunner(p.mtip, sched)(
            p.initial_density_batch(1, 2))
        order, _ = rank_restarts(states)
        aux = dict(grid=None, initial_support=p.initial_support,
                   avg_intensity=p.average_intensity, wavelength=1.0,
                   proj=list(p.projection_matrices), rc=2.0,
                   dimensions=3, data_scale=4.0)
        res = w._collect_results(p.mtip, p.ft, aux, states, errors, order,
                                 seed=5)
    return res, states, errors, order, 2.0
