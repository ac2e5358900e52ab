"""Mesh sharding correctness: dp and dp×tp sharded phasing must reproduce
the single-device trajectory bit-for-tolerance."""
import numpy as np
import jax
import pytest

from xframe_tpu.parallel.mesh import (make_mesh, default_mesh_axes,
                                      MultiStartRunner, CheckpointingRunner)
from xframe_tpu.projects.fxs.demo import make_demo_problem
from xframe_tpu.projects.fxs.phasing import Segment


@pytest.fixture(scope="module")
def problem():
    return make_demo_problem(16, 8)


@pytest.fixture(scope="module")
def schedule(problem):
    return [
        Segment("HIO", 6, betas=np.full(6, 0.5), ft_stab=True),
        Segment("SW", sigma=problem.mtip.sw.default_sigma, threshold=0.1),
        Segment("ER", 4, betas=np.zeros(4), ft_stab=True),
    ]


def test_mesh_axes_factorization():
    assert default_mesh_axes(8) == {"restarts": 4, "theta": 2}
    assert default_mesh_axes(2) == {"restarts": 2}
    assert default_mesh_axes(1) == {"restarts": 1}


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_matches_unsharded(problem, schedule):
    rho0s = problem.initial_density_batch(0, 8)
    ref_states, ref_errors = MultiStartRunner(problem.mtip, schedule,
                                              mesh=None)(rho0s)
    ref_errors = np.asarray(ref_errors)

    for axes in ({"restarts": 8}, {"restarts": 4, "theta": 2}):
        mesh = make_mesh(axes)
        states, errors = MultiStartRunner(problem.mtip, schedule, mesh)(rho0s)
        errors = np.asarray(errors)
        assert errors.shape == ref_errors.shape
        # tp-sharding changes the f32 reduction order of the θ contraction:
        # trajectories agree to single-precision accumulation tolerance
        assert np.allclose(errors, ref_errors, rtol=2e-2, atol=1e-5), axes
        assert np.allclose(np.asarray(states.best_err),
                           np.asarray(ref_states.best_err), rtol=2e-2)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_checkpointing_runner_sharded(problem, schedule, tmp_path):
    rho0s = problem.initial_density_batch(3, 8)
    mesh = make_mesh({"restarts": 4, "theta": 2})
    ref_states, ref_errors = MultiStartRunner(problem.mtip, schedule,
                                              mesh=None)(rho0s)
    runner = CheckpointingRunner(problem.mtip, schedule, mesh,
                                 checkpoint_path=str(tmp_path / "ck.h5"))
    states, errors = runner(rho0s)
    assert np.allclose(np.asarray(errors), np.asarray(ref_errors),
                       rtol=2e-2, atol=1e-5)


def test_checkpointing_runner_resume(problem, schedule, tmp_path):
    """Interrupt after one chunk, resume with a FRESH runner from the
    snapshot; the completed run matches an uninterrupted one."""
    rho0s = problem.initial_density_batch(5, 4)
    ck = str(tmp_path / "resume.h5")
    ref_states, ref_errors = CheckpointingRunner(
        problem.mtip, schedule, None, checkpoint_path=None)(rho0s,
                                                            resume=False)
    first = CheckpointingRunner(problem.mtip, schedule, None,
                                checkpoint_path=ck)
    assert len(first.chunks) >= 2, "schedule must split into >=2 chunks"
    first(rho0s, resume=False, max_chunks=1)
    import os
    assert os.path.exists(ck)
    second = CheckpointingRunner(problem.mtip, schedule, None,
                                 checkpoint_path=ck)
    states, errors = second(rho0s, resume=True)
    assert np.asarray(errors).shape == np.asarray(ref_errors).shape
    assert np.allclose(np.asarray(errors), np.asarray(ref_errors),
                       rtol=2e-2, atol=1e-5)
    assert np.allclose(np.asarray(states.best_err),
                       np.asarray(ref_states.best_err), rtol=2e-2, atol=1e-5)


def test_checkpointing_runner_reuses_initial_state_jit(problem, schedule):
    """Regression: a fresh jax.jit(initial_state_batch) wrapper per __call__
    re-traced and re-hashed the embedded initial-support constant on every
    run (seconds per call at production scale). The wrapper
    is built once in __init__ with the support as a device argument, so
    repeated same-shape calls must hit one compiled entry."""
    runner = CheckpointingRunner(problem.mtip, schedule, None)
    rho0s = problem.initial_density_batch(7, 2)
    runner(rho0s, resume=False)
    runner(rho0s, resume=False)
    assert runner._init_state._cache_size() == 1


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_theta_mesh_with_weights_as_arguments(problem):
    """L_max-scaling path (SURVEY.md §5): on grids whose Hankel tables are
    too large to embed as jit constants (unwise beyond ~100 MB), the tables
    enter the
    sharded program as ARGUMENTS (hankel.weight_planes) — replicated over a
    restarts×theta mesh while the density batch shards over both axes. The
    result must match the constant-embedded single-device FT roundtrip."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from xframe_tpu.ops.hankel import weight_planes, apply_hankel_planes

    ft = problem.ft
    sz = ft.hankel.skip_zero
    (wf_re, wf_im), (wi_re, wi_im) = weight_planes(ft.hankel)
    rho0s = problem.initial_density_batch(11, 8)

    def roundtrip(w4, rho):
        f_re, f_im, i_re, i_im = w4
        c = ft.sht.forward(rho)
        psi = ft.sht.inverse(apply_hankel_planes(f_re, f_im, c, sz))
        c2 = ft.sht.forward(psi)
        return ft.sht.inverse(apply_hankel_planes(i_re, i_im, c2, sz))

    mesh = make_mesh({"restarts": 4, "theta": 2})
    batch_sh = NamedSharding(mesh, P("restarts", None, "theta", None))
    repl = NamedSharding(mesh, P())
    w4 = tuple(jax.device_put(jnp.asarray(w), repl)
               for w in (wf_re, wf_im, wi_re, wi_im))
    rho_sh = jax.device_put(rho0s, batch_sh)
    out = jax.jit(jax.vmap(roundtrip, in_axes=(None, 0)))(w4, rho_sh)

    ref = jax.jit(jax.vmap(lambda r: ft.inverse(ft.forward(r))))(rho0s)
    out_h, ref_h = np.asarray(out), np.asarray(ref)
    scale = np.abs(ref_h).max()
    assert np.abs(out_h - ref_h).max() / scale < 2e-5
    # the batch really was sharded over both mesh axes
    assert len(out.sharding.device_set) == 8


def test_multiprocess_distributed_mesh():
    """Two OS processes × 4 virtual CPU devices joined by jax.distributed
    into one 8-device global mesh: the restart-sharded phasing run executes
    as a single SPMD program spanning both processes (the multi-host path
    behind the CLI's --distributed flag; the reference's multi-node layer is
    an empty stub, Multiprocessing.py:32-61)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "tests", "_distributed_worker.py")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = ""
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, script, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=root, env=env) for i in range(2)]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=600)
            outs.append(out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for i, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
        assert f"DIST OK p{i}" in out, out[-3000:]


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_runner_arg_tables_sharded_matches_embedded(schedule):
    """MultiStartRunner: the production-payload path (big tables as
    replicated jit arguments) under a restart mesh must reproduce the
    embedded-constant unsharded run."""
    p = make_demo_problem(16, 8)
    rho0s = p.initial_density_batch(5, 8)
    sched = [
        Segment("HIO", 6, betas=np.full(6, 0.5), ft_stab=True),
        Segment("SW", sigma=p.mtip.sw.default_sigma, threshold=0.1),
        Segment("ER", 4, betas=np.zeros(4), ft_stab=True),
    ]
    ref_states, ref_errors = jax.jit(
        lambda r: p.mtip.run_batch(r, sched))(rho0s)
    mesh = make_mesh({"restarts": 8})
    run = MultiStartRunner(p.mtip, sched, mesh=mesh)
    assert run._tables, "the runner must pass the tables as arguments"
    states, errors = run(rho0s)
    # sharded vs unsharded differ at f32 rounding level; the bitwise
    # tables-vs-embedded check (no mesh) lives in test_phasing
    np.testing.assert_allclose(np.asarray(ref_errors), np.asarray(errors),
                               atol=2e-5, rtol=2e-4)
    scale = np.abs(np.asarray(ref_states.best_rho)).max()
    assert np.abs(np.asarray(ref_states.best_rho)
                  - np.asarray(states.best_rho)).max() / scale < 2e-4


def test_runner_arg_tables_auto_threshold(monkeypatch):
    """The runner (as the reconstruct worker builds it) passes the tables as
    arguments at every scale — embedded V/PD constants change with every
    extract output and defeat the persistent compile cache — and no
    environment variable switches that off; results equal the
    embedded-constant run exactly."""
    p = make_demo_problem(16, 8)
    sched = [Segment("HIO", 3, betas=np.full(3, 0.5), ft_stab=True)]
    rho0s = p.initial_density_batch(11, 2)
    monkeypatch.setenv("XF_ARG_TABLES", "0")
    run_big = MultiStartRunner(p.mtip, sched, mesh=None)
    assert set(run_big._tables) == set(p.mtip.arg_tables())
    ref = jax.jit(lambda r: p.mtip.run_batch(r, sched))(rho0s)
    out = run_big(rho0s)
    np.testing.assert_array_equal(np.asarray(ref[1]), np.asarray(out[1]))
    np.testing.assert_array_equal(np.asarray(ref[0].best_rho),
                                  np.asarray(out[0].best_rho))


def test_checkpointing_runner_arg_tables(tmp_path, schedule):
    """CheckpointingRunner (tables as arguments) reproduces the embedded run
    and still checkpoints/resumes."""
    p = make_demo_problem(16, 8)
    rho0s = p.initial_density_batch(7, 2)
    sched = [
        Segment("HIO", 4, betas=np.full(4, 0.5), ft_stab=True),
        Segment("SW", sigma=p.mtip.sw.default_sigma, threshold=0.1),
        Segment("ER", 2, betas=np.zeros(2), ft_stab=True),
    ]
    ref_states, ref_errors = jax.jit(
        lambda r: p.mtip.run_batch(r, sched))(rho0s)
    ck = str(tmp_path / "ck.h5")
    run = CheckpointingRunner(p.mtip, sched, checkpoint_path=ck)
    assert run._tables
    states, errors = run(rho0s, resume=False)
    np.testing.assert_allclose(np.asarray(ref_errors), np.asarray(errors),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(np.asarray(ref_states.best_rho),
                                  np.asarray(states.best_rho))


def _dense_constant_shapes(lowered):
    """Shapes of the constants a lowered program embeds element by element
    (splats and constants of at most 16 elements excluded)."""
    shapes = []

    def walk(op):
        for region in op.regions:
            for block in region:
                for o in block.operations:
                    if (o.operation.name == "stablehlo.constant"
                            and "__elided__" in o.operation.get_asm(
                                large_elements_limit=16)):
                        shapes.append(tuple(o.result.type.shape))
                    walk(o.operation)

    walk(lowered.compiler_ir("stablehlo").operation)
    return shapes


def test_runner_program_embeds_no_table_or_grid(problem):
    """The runner's program takes every table and the initial support as
    arguments: embedded, each traced use became its own constant, and the
    600-iteration tutorial program grew past the 2 GB an executable may
    serialize to (the persistent compile cache then refused it)."""
    from xframe_tpu.projects.fxs.phasing import tutorial_schedule
    runner = MultiStartRunner(problem.mtip,
                              tutorial_schedule(problem.mtip.sw.default_sigma))
    grid = tuple(problem.ft.grid_shape)
    r0 = jax.ShapeDtypeStruct((2,) + grid, np.complex64)
    shapes = set(_dense_constant_shapes(runner._jitted.lower(r0,
                                                             runner._tables)))
    table_shapes = {np.shape(v) for v in problem.mtip.arg_tables().values()}
    assert grid in table_shapes            # the initial support
    assert not shapes & table_shapes, shapes & table_shapes
    assert all(int(np.prod(s)) < int(np.prod(grid)) for s in shapes), shapes


def test_tutorial_schedule_structure():
    """The reference tutorial's main loop: 5×(60 HIO + SW + 40 ER) + SW +
    100 ER — 600 iterations and 6 shrink-wraps."""
    from xframe_tpu.projects.fxs.phasing import tutorial_schedule
    sched = tutorial_schedule(1.5)
    assert sum(s.n for s in sched if s.method != "SW") == 600
    assert [s.method for s in sched].count("SW") == 6
    assert sum(s.n for s in sched if s.method == "HIO") == 300
    assert all(s.sigma == 1.5 and s.threshold == 0.1
               for s in sched if s.method == "SW")
    assert all(s.ft_stab for s in sched if s.method != "SW")
