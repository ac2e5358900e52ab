"""2D (polar) MTIP phasing tests."""
import numpy as np
import jax

from xframe_tpu.projects.fxs.demo import make_demo_problem_2d
from xframe_tpu.projects.fxs.phasing import Segment
from xframe_tpu.projects.fxs import invariants as itools


def test_phasing2d_converges_and_recovers_invariants():
    p = make_demo_problem_2d(32, 16, 64)
    mtip = p.mtip
    schedule = [
        Segment("HIO", 40, betas=np.full(40, 0.5), ft_stab=True),
        Segment("SW", sigma=mtip.sw.default_sigma * 2, threshold=0.09),
        Segment("ER", 20, betas=np.zeros(20), ft_stab=True),
        Segment("SW", sigma=mtip.sw.default_sigma, threshold=0.09),
        Segment("ER", 40, betas=np.zeros(40), ft_stab=True),
    ]
    rho0 = p.initial_density_batch(7, 1)[0]
    run = jax.jit(lambda r: mtip.run(r, schedule))
    state, errors = run(rho0)
    errors = np.asarray(errors)
    assert np.isfinite(errors).all()
    errors = errors[:, 0]
    assert errors[-1] < 0.2 * errors[:5].mean()

    # invariant fingerprint: B_m of the reconstruction matches the data
    coeff = np.asarray(jax.jit(
        lambda r: p.cht.forward((lambda ps: (ps * ps.conj()).real)(
            p.ft.forward(r))))(state.best_rho))
    bm_rec = itools.harmonic_coeff_to_deg2_invariants_2d(coeff)
    bm = p.bm
    s = slice(4, None)
    for m in [0, 2, 4]:
        scale = np.abs(bm[m][s, s]).max()
        rel = np.abs(np.abs(bm_rec[m][s, s]) - np.abs(bm[m][s, s])).max() / scale
        assert rel < 0.35, f"m={m}: invariant mismatch {rel}"


def test_phasing2d_multi_start():
    p = make_demo_problem_2d(24, 12, 64)
    schedule = [
        Segment("HIO", 10, betas=np.full(10, 0.5), ft_stab=True),
        Segment("SW", sigma=p.mtip.sw.default_sigma, threshold=0.09),
        Segment("ER", 5, betas=np.zeros(5), ft_stab=True),
    ]
    rho0s = p.initial_density_batch(0, 3)
    run = jax.jit(lambda r: p.mtip.run_batch(r, schedule))
    states, errors = run(rho0s)
    errors = np.asarray(errors)
    assert errors.shape == (3, 15, 2)
    assert np.isfinite(errors).all()
    errors = errors[..., 0]
    assert (errors[:, -1] < errors[:, 0]).all()
