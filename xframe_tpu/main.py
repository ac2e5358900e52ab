"""CLI: `xframe-tpu <project> <worker> [settings]`.

Mirrors the reference command surface (reference xframe/main.py:102-175):
one subcommand per discovered project, one per worker module, with the
settings name as optional argument. Also exposes `--setup_home` scaffolding
and `--print_home` (reference startup_routines.py:415-518).
"""
from __future__ import annotations

import argparse
import importlib
import os
import pkgutil
import shutil
import sys


def discover_projects():
    """{project: [workers]} from xframe_tpu.projects.* modules that define a
    ProjectWorker, plus user projects under <home>/projects/. Honors
    settings.general.load_projects ('all' or a name list, reference
    general.py:42)."""
    import xframe_tpu.projects as proj_pkg
    from xframe_tpu.settings import loader as settings_loader
    from xframe_tpu import settings
    found = {}
    for pkg in (proj_pkg,):
        for mod in pkgutil.iter_modules(pkg.__path__):
            if not mod.ispkg:
                continue
            sub = importlib.import_module(f"{pkg.__name__}.{mod.name}")
            workers = [m.name for m in pkgutil.iter_modules(sub.__path__)
                       if not m.ispkg and not m.name.startswith("_")]
            workers = [w for w in workers
                       if w not in ("demo", "invariants", "projections",
                                    "phasing", "alignment",
                                    "resolution_metrics")]
            if workers:
                found[mod.name] = sorted(workers)
    home_projects = os.path.join(settings_loader.home_dir(), "projects")
    if os.path.isdir(home_projects):
        for name in sorted(os.listdir(home_projects)):
            p = os.path.join(home_projects, name)
            if os.path.isdir(p):
                workers = sorted(f[:-3] for f in os.listdir(p)
                                 if f.endswith(".py") and not f.startswith("_"))
                if workers:
                    found.setdefault(name, workers)
    wanted = settings.general.get("load_projects", "all")
    if isinstance(wanted, str) and wanted != "all":
        wanted = [wanted]               # YAML scalar: `load_projects: fxs`
    if wanted != "all" and isinstance(wanted, (list, tuple)):
        found = {k: v for k, v in found.items() if k in wanted}
    return found


def _project_help(project):
    """(description, {worker: (short, long)}) from the project's optional
    _argparser_ module (reference projects/fxs/_argparser_.py)."""
    try:
        mod = importlib.import_module(
            f"xframe_tpu.projects.{project}._argparser_")
    except ModuleNotFoundError:
        return None, {}
    return (getattr(mod, "PROJECT_DESCRIPTION", None),
            getattr(mod, "WORKER_HELP", {}))


def setup_home(path=None):
    """Create the home folder tree (settings/data/projects/cache)."""
    from xframe_tpu.settings import loader as settings_loader
    home = path or settings_loader.home_dir()
    for sub in ("settings/projects", "settings/experiments", "data",
                "projects", "cache"):
        os.makedirs(os.path.join(home, sub), exist_ok=True)
    # copy the bundled tutorial settings as editable starting points
    install = settings_loader.install_dir()
    proj_root = os.path.join(install, "projects")
    for project in os.listdir(proj_root):
        sdir = os.path.join(proj_root, project, "settings")
        if not os.path.isdir(sdir):
            continue
        for worker in os.listdir(sdir):
            src = os.path.join(sdir, worker, "tutorial.yaml")
            if os.path.exists(src):
                dst_dir = os.path.join(home, "settings", "projects", project,
                                       worker)
                os.makedirs(dst_dir, exist_ok=True)
                dst = os.path.join(dst_dir, "tutorial.yaml")
                if not os.path.exists(dst):
                    shutil.copy(src, dst)
    # per-experiment tutorial settings (edited copies selected via -eset)
    exp_root = os.path.join(install, "experiments")
    if os.path.isdir(exp_root):
        for exp in os.listdir(exp_root):
            src = os.path.join(exp_root, exp, "settings", "tutorial.yaml")
            if os.path.exists(src):
                dst_dir = os.path.join(home, "settings", "experiments", exp)
                os.makedirs(dst_dir, exist_ok=True)
                dst = os.path.join(dst_dir, "tutorial.yaml")
                if not os.path.exists(dst):
                    shutil.copy(src, dst)
    print(f"xframe_tpu home initialized at {home}")
    return home


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="xframe-tpu",
        description="JAX FXS reconstruction framework")
    parser.add_argument("--setup_home", action="store_true",
                        help="create the home folder tree and exit")
    parser.add_argument("-d", "--debug", action="store_true",
                        help="verbose logging")
    parser.add_argument("--distributed", action="store_true",
                        help="initialize jax.distributed (multi-host meshes; "
                             "coordinator/process env per JAX docs)")
    parser.add_argument("--print_home", action="store_true")
    parser.add_argument("--version", action="store_true")
    sub = parser.add_subparsers(dest="project")
    vp = sub.add_parser("view", help="render reconstruction/average h5 "
                                     "outputs to PNG (headless viewer)")
    vp.add_argument("file", help="reconstructions/average HDF5 file")
    vp.add_argument("-o", "--out", default=None, help="output folder "
                    "(default: next to the input file)")
    vp.add_argument("-n", "--max-results", type=int, default=4)
    projects = discover_projects()
    for project, workers in projects.items():
        desc, whelp = _project_help(project)
        p = sub.add_parser(project, help=desc, description=desc)
        ws = p.add_subparsers(dest="worker")
        for w in workers:
            short, long_ = whelp.get(w, (None, None))
            wp = ws.add_parser(w, help=short, description=long_)
            wp.add_argument("settings", nargs="?", default=None,
                            help="settings name (resolved through the "
                                 "settings folder precedence) or a .yaml path")
            wp.add_argument("-e", "--experiment", default=None,
                            help="experiment to bind for comm.get_data "
                                 "(e.g. SPB)")
            wp.add_argument("-eset", "--experiment_settings", default=None,
                            metavar="FILE_NAME",
                            help="experiment settings name, loaded into "
                                 "settings.experiment through the experiment "
                                 "settings precedence (requires -e)")

    args = parser.parse_args(argv)
    from xframe_tpu import settings as _settings
    from xframe_tpu.logger import setup_logging
    setup_logging("DEBUG" if getattr(args, "debug", False)
                  else _settings.general.get("loglevel", "WARNING"))
    if getattr(args, "distributed", False):
        import jax
        jax.distributed.initialize()
    if args.version:
        import xframe_tpu
        print(xframe_tpu.__version__)
        return 0
    if args.setup_home:
        setup_home()
        return 0
    if args.print_home:
        from xframe_tpu.settings import loader as settings_loader
        print(settings_loader.home_dir())
        return 0
    if args.project == "view":
        from xframe_tpu.presenters.viewer import view_file
        for p in view_file(args.file, out_dir=args.out,
                           max_results=args.max_results):
            print(p)
        return 0
    if not args.project or not getattr(args, "worker", None):
        parser.print_help()
        return 1

    import xframe_tpu
    xframe_tpu.select_project(args.project, args.worker,
                              getattr(args, "settings", None))
    if getattr(args, "experiment", None):
        from xframe_tpu import comm, settings
        # the project settings' `experiment` block provides per-project
        # overrides on top of the experiment settings tree (-eset)
        ekw = settings.project.get("experiment", {})
        ekw = ekw.dict() if hasattr(ekw, "dict") else dict(ekw)
        ekw.pop("name", None)
        comm.select_experiment(args.experiment,
                               getattr(args, "experiment_settings", None),
                               **ekw)
    elif getattr(args, "experiment_settings", None):
        # -eset names experiment settings but no experiment module was
        # selected — silently ignoring an explicit request would run the
        # worker with no experiment bound (reference binds -eset through
        # the selected experiment, startup_routines.py:249-258)
        raise SystemExit(
            f"-eset {args.experiment_settings!r} requires -e/--experiment "
            "to select the experiment module it configures")
    xframe_tpu.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
