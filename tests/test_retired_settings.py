"""Settings keys of removed features still load, are ignored and logged,
and leave the reconstruct worker on the plain jnp path.

fused_sht / fused_bf16_tables (the removed fused SHT kernels),
main_loop.best_tracking (the removed replay/lazy best bookkeeping) and
procrustes_method: newton_schulz_pallas (the removed polar kernel, read as
newton_schulz) appear in archived settings files; loading one must neither
fail nor change what runs.
"""
import logging
import os

import numpy as np
import pytest
import jax

import xframe_tpu as xf


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    path = tmp_path_factory.mktemp("xf_retired_home")
    old = os.environ.get("XFRAME_TPU_HOME")
    os.environ["XFRAME_TPU_HOME"] = str(path)
    yield str(path)
    if old is None:
        os.environ.pop("XFRAME_TPU_HOME", None)
    else:
        os.environ["XFRAME_TPU_HOME"] = old


@pytest.fixture(scope="module")
def invariants():
    """Extract-format invariants of the demo's two-ball density."""
    from xframe_tpu.projects.fxs.demo import make_demo_problem
    p = make_demo_problem(12, 6)
    return {"dimensions": 3, "data_radial_points": np.asarray(p.ft.qs),
            "max_order": 6,
            "data_projection_matrices": {"I1I1": list(p.projection_matrices)},
            "average_intensity": np.asarray(p.average_intensity),
            "xray_wavelength": 1.0}


RETIRED = [
    ({"fourier_transform": {"fused_sht": "auto"}}, "fourier_transform.fused_sht"),
    ({"fourier_transform": {"fused_sht": True}}, "fourier_transform.fused_sht"),
    ({"fourier_transform": {"fused_sht": False}}, "fourier_transform.fused_sht"),
    ({"fourier_transform": {"fused_bf16_tables": True}},
     "fourier_transform.fused_bf16_tables"),
    ({"main_loop": {"best_tracking": "replay"}}, "main_loop.best_tracking"),
    ({"main_loop": {"best_tracking": "eager"}}, "main_loop.best_tracking"),
    ({"main_loop": {"best_tracking": "lazy"}}, "main_loop.best_tracking"),
    ({"projections": {"reciprocal": {
        "procrustes_method": "newton_schulz_pallas"}}},
     "projections.reciprocal.procrustes_method: newton_schulz_pallas"),
]


@pytest.mark.parametrize("override,name", RETIRED,
                         ids=[f"{n.split('.')[-1]}-{i}"
                              for i, (_, n) in enumerate(RETIRED)])
def test_retired_key_accepted_and_plain_path(home, invariants, caplog,
                                             override, name):
    from xframe_tpu.projects.fxs.phasing import Segment
    from xframe_tpu.projects.fxs.reconstruct import ProjectWorker
    overrides = {"structure_name": "retired", "dimensions": 3,
                 "grid": {"n_radial_points": 12, "max_order": 6,
                          "n_theta": 0, "n_phi": 0}}
    for section, sub in override.items():
        overrides[section] = sub
    xf.select_project("fxs", "reconstruct", "tutorial", overrides=overrides)
    caplog.set_level(logging.INFO, logger="xframe_tpu")
    w = ProjectWorker()
    mtip, ft, aux = w.setup_mtip(invariants)
    assert f"retired setting {name} ignored" in caplog.text
    assert mtip.rc.procrustes_method in ("newton_schulz", "svd")
    assert not hasattr(ft, "_fused")
    sched = [Segment("HIO", 2, betas=np.full(2, 0.5), ft_stab=True)]
    rho0 = aux["initial_density_batch"](0, 1)
    _, errors = jax.jit(lambda r: mtip.run_batch(r, sched))(rho0)
    assert np.isfinite(np.asarray(errors)).all()
