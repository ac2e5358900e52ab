"""Dynamic ft_stab (`link_to_enforce_initial_support`, VERDICT r4 #7).

Reference semantics (reconstruct.py:836-850): a linked method applies the
ft-stab correction iff at least `delay` shrink-wrap events have happened AND
none of the last `delay` enforced the initial support (enforcement = the
error before the SW exceeded `enforce_initial_support.if_error_bigger_than`).

The rebuild realizes the decision as a carried 0/1 gate multiplying the
compiled ft-stab structure (phasing._ft_gate / PhasingState.enforce_hist).
These tests pin the equivalence: a linked schedule must match the SAME
schedule with ft_stab flags resolved by hand from the observed enforce flags
— per-iteration errors and final densities — on the jnp path and through
the chunked CheckpointingRunner."""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from xframe_tpu.projects.fxs.demo import make_demo_problem
from xframe_tpu.projects.fxs.phasing import MTIP, Segment, build_schedule


@pytest.fixture(scope="module")
def demo():
    return make_demo_problem(12, 6)


def _mtip_clone(p, enforce_limit=np.inf):
    """Fresh MTIP on the demo's constraints."""
    m = p.mtip
    return MTIP(p.ft, m.rc, m.real, m.sw, m._w_err_host, m.initial_support,
                enforce_initial_support_limit=enforce_limit)


def _linked_schedule(sw_sigma, delay=1):
    return [
        Segment("HIO", 5, betas=np.linspace(0.6, 0.4, 5), ft_stab=True,
                ft_stab_link_delay=delay),
        Segment("SW", sigma=sw_sigma, threshold=0.1),
        Segment("ER", 4, betas=np.zeros(4), ft_stab=True,
                ft_stab_link_delay=delay),
        Segment("SW", sigma=sw_sigma, threshold=0.12),
        Segment("HIO", 4, betas=np.full(4, 0.5), ft_stab=True,
                ft_stab_link_delay=delay),
        Segment("ER", 3, betas=np.zeros(3), ft_stab=True),
    ]


def _resolved_schedule(sched, flags, delay=1):
    """Hand-resolve the link rule into static ft_stab booleans given the
    per-SW enforce flags (the reference's change_to_ft_stab logic)."""
    out, hist = [], []
    for seg in sched:
        if seg.method in ("SW", "SW_center"):
            hist.append(flags[len(hist)])
            out.append(seg)
        elif seg.ft_stab_link_delay:
            d = seg.ft_stab_link_delay
            on = len(hist) >= d and not any(hist[-d:])
            out.append(Segment(seg.method, seg.n, betas=seg.betas,
                               ft_stab=on))
        else:
            out.append(seg)
    return out


def _run(mtip, sched, rho0):
    state, errs = jax.jit(lambda r: mtip.run(r, sched))(rho0)
    return state, np.asarray(errs)


def _assert_same(s_a, e_a, s_b, e_b, tol=2e-5):
    np.testing.assert_allclose(e_a, e_b, rtol=tol, atol=1e-7)
    scale = np.abs(np.asarray(s_b.rho)).max()
    assert np.abs(np.asarray(s_a.rho) - np.asarray(s_b.rho)).max() \
        < tol * scale
    np.testing.assert_allclose(float(s_a.best_err), float(s_b.best_err),
                               rtol=tol)


@pytest.mark.parametrize("limit,flags", [
    (np.inf, [False, False]),     # never enforced → ft turns ON after SW 1
    (-1.0, [True, True]),         # always enforced → ft stays OFF
])
def test_linked_matches_hand_resolved(demo, limit, flags):
    p = demo
    sched = _linked_schedule(p.mtip.sw.default_sigma)
    rho0 = p.initial_density_batch(5, 1)[0]
    m_dyn = _mtip_clone(p, enforce_limit=limit)
    s_dyn, e_dyn = _run(m_dyn, sched, rho0)
    # the dynamic run must have recorded exactly these enforce flags
    hist = np.asarray(s_dyn.enforce_hist)
    assert hist.shape[-1] == 1          # delay 1 → history length 1
    m_st = _mtip_clone(p, enforce_limit=limit)
    s_st, e_st = _run(m_st, _resolved_schedule(sched, flags), rho0)
    _assert_same(s_dyn, e_dyn, s_st, e_st)


def test_linked_mixed_enforcement(demo):
    """Pick an enforce limit BETWEEN the two pre-SW errors so the two SW
    events record different flags — the gate must flip mid-run."""
    p = demo
    sched = _linked_schedule(p.mtip.sw.default_sigma)
    rho0 = p.initial_density_batch(7, 1)[0]
    probe, e = _run(_mtip_clone(p), sched, rho0)
    pre_sw = sorted([e[4, 0], e[8, 0]])   # errors entering SW 1 and SW 2
    if np.isclose(pre_sw[0], pre_sw[1], rtol=1e-3):
        pytest.skip("pre-SW errors coincide; cannot split them")
    limit = float(np.sqrt(pre_sw[0] * pre_sw[1]))
    m_dyn = _mtip_clone(p, enforce_limit=limit)
    s_dyn, e_dyn = _run(m_dyn, sched, rho0)
    flags = [bool(e_dyn[4, 0] > limit), bool(e_dyn[8, 0] > limit)]
    assert flags[0] != flags[1]
    m_st = _mtip_clone(p, enforce_limit=limit)
    s_st, e_st = _run(m_st, _resolved_schedule(sched, flags), rho0)
    _assert_same(s_dyn, e_dyn, s_st, e_st)
    # and the carried history holds the newest flag
    assert bool(np.asarray(s_dyn.enforce_hist)[-1]) == flags[1]


def test_linked_delay2_gate_stays_off_until_two_events(demo):
    """delay=2: the gate is 0 until two real SW events exist (all-True
    padding), then 1 iff neither of the last two enforced."""
    p = demo
    sched = _linked_schedule(p.mtip.sw.default_sigma, delay=2)
    rho0 = p.initial_density_batch(9, 1)[0]
    m_dyn = _mtip_clone(p)                 # limit inf: never enforce
    s_dyn, e_dyn = _run(m_dyn, sched, rho0)
    # hand resolution: seg1 off (0 events), seg3 off (1 event < delay),
    # seg5 ON (2 events, none enforced)
    m_st = _mtip_clone(p)
    static = _resolved_schedule(sched, [False, False], delay=2)
    assert [s.ft_stab for s in static if s.method != "SW"] \
        == [False, False, True, True]
    s_st, e_st = _run(m_st, static, rho0)
    _assert_same(s_dyn, e_dyn, s_st, e_st)


def test_linked_checkpoint_runner_matches(demo, tmp_path):
    """CheckpointingRunner (chunked run_chunk structures carrying the link
    delay + enforce_hist through save/load) matches the direct run."""
    from xframe_tpu.parallel.mesh import CheckpointingRunner
    p = demo
    sched = _linked_schedule(p.mtip.sw.default_sigma)
    rho0s = p.initial_density_batch(11, 2)
    m_a = _mtip_clone(p)
    s_a, e_a = jax.jit(lambda r: m_a.run_batch(r, sched))(rho0s)
    m_b = _mtip_clone(p)
    ckpt = str(tmp_path / "link_ckpt.h5")
    runner = CheckpointingRunner(m_b, sched, checkpoint_path=ckpt)
    # run the first chunk, then resume from disk for the rest — the
    # enforce history must survive the checkpoint round-trip
    runner(rho0s, resume=False, max_chunks=1)
    m_c = _mtip_clone(p)
    runner2 = CheckpointingRunner(m_c, sched, checkpoint_path=ckpt)
    s_b, e_b = runner2(rho0s, resume=True)
    np.testing.assert_allclose(np.asarray(e_b), np.asarray(e_a),
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(s_b.best_err),
                               np.asarray(s_a.best_err), rtol=2e-5)


def test_build_schedule_parses_link(demo):
    """The settings path: ft_stab: link_to_enforce_initial_support with a
    delay lands on Segment.ft_stab_link_delay (reference reconstruct.py:844)."""
    main_loop = {"order": ["main"], "main": {
        "iterations": 1, "order": ["HIO", "SW", "ER"],
        "methods": {
            "HIO": {"iterations": 3,
                    "ft_stab": "link_to_enforce_initial_support",
                    "link_to_enforce_initial_support": {"delay": 2}},
            "SW": {"iterations": 1},
            "ER": {"iterations": 2, "ft_stab": True},
        }}}
    segs = build_schedule(main_loop, [[0.5, 0.5, -1 / 700, 1600]], [False],
                          [0.1], {}, default_sigma=3.0)
    hio = [s for s in segs if s.method == "HIO"][0]
    er = [s for s in segs if s.method == "ER"][0]
    assert hio.ft_stab is True and hio.ft_stab_link_delay == 2
    assert er.ft_stab is True and er.ft_stab_link_delay == 0
    with pytest.raises(ValueError):
        bad = {"order": ["main"], "main": {
            "iterations": 1, "order": ["HIO"],
            "methods": {"HIO": {"iterations": 1, "ft_stab": "bogus"}}}}
        build_schedule(bad, [[0.5, 0.5, -1 / 700, 1600]], [False], [0.1],
                       {}, default_sigma=3.0)
