"""xframe_tpu — fluctuation X-ray scattering (FXS) reconstruction framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of European-XFEL/xFrame
(reference layout documented in SURVEY.md): angular cross-correlation of
detector frames, rotational-invariant (B_l) extraction, MTIP iterative phasing
(HIO/ER/RAAR + shrink-wrap), and SO(3) alignment/averaging — with the entire
phasing iteration jit-compiled on device and multi-start reconstructions
sharded over a device mesh.

Top-level API (mirrors the reference's scripting interface,
/root/reference/xframe/startup_routines.py:221-350):

    import xframe_tpu as xf
    xf.select_project('fxs', 'reconstruct', 'tutorial')
    xf.settings.project.grid.n_radial_points = 64   # optional overrides
    xf.run()
"""

__version__ = "0.1.0"

from xframe_tpu import settings  # noqa: F401
from xframe_tpu import database  # noqa: F401

_selected = {"project": None, "worker": None, "settings_name": None}


def select_project(project, worker, settings_name=None, overrides=None):
    """Select a (project, worker) pair and load its settings.

    Mirrors xframe.select_project (reference startup_routines.py:221-247).
    """
    from xframe_tpu.settings import load_settings

    load_settings(project, worker, settings_name, overrides=overrides)
    _selected.update(project=project, worker=worker, settings_name=settings_name)
    # expose the project database for scripting (reference
    # docs/fxs/scripting.md "Accessing project files": xframe.database.project)
    from xframe_tpu import database
    database._select(project)


def select_experiment(name, settings_name=None, **kwargs):
    """Select an experiment (e.g. 'SPB') and load its settings into
    `settings.experiment` (reference xframe.select_experiment,
    startup_routines.py:249-258; CLI: `-e <name> -eset <settings>`)."""
    from xframe_tpu import comm
    return comm.select_experiment(name, settings_name, **kwargs)


def run():
    """Instantiate the selected worker and run it (reference
    startup_routines.py:270-350). Workers resolve from the built-in
    `xframe_tpu.projects` package first, then from `<home>/projects/<project>/
    <worker>.py` (user projects, reference home-folder discovery)."""
    import importlib
    import importlib.util
    import os

    # persistent XLA compile cache: tutorial-scale programs take minutes to
    # compile on this class of host — warm every worker run, not just bench
    from xframe_tpu.library.compile_cache import enable as _enable_cache
    _enable_cache()

    project, worker = _selected["project"], _selected["worker"]
    if project is None:
        raise RuntimeError("No project selected. Call select_project() first.")
    try:
        mod = importlib.import_module(f"xframe_tpu.projects.{project}.{worker}")
    except ModuleNotFoundError:
        from xframe_tpu.settings import loader as settings_loader
        path = os.path.join(settings_loader.home_dir(), "projects", project,
                            f"{worker}.py")
        if not os.path.exists(path):
            raise
        spec = importlib.util.spec_from_file_location(
            f"xframe_tpu_user.{project}.{worker}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    worker_cls = settings.general.get("default_project_worker_name",
                                      "ProjectWorker")
    w = getattr(mod, worker_cls)()
    return w.run()


def select_and_run(project, worker, settings_name=None, overrides=None):
    select_project(project, worker, settings_name, overrides=overrides)
    return run()
