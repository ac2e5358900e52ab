"""YAML settings dialect: versioned defaults + dynamic directives.

Re-implements the behavior of the reference settings system
(/root/reference/xframe/database/database.py:403-698):

  * a named settings file `<name>.yaml` is searched through a folder
    precedence list (user home first, install tree last);
  * it is completed against the highest-version `default_<ver>.yaml`
    (or the version pinned by a `settings_version` key);
  * any mapping containing a `command` key is replaced by the evaluated
    expression (numpy available as `np`, sandboxed builtins);
  * default entries may carry directives, applied in order:
      _only_if: {x: <path>, condition: <expr of x>}   — drop entry if false
      _copy: <path>                                   — copy default subtree
      _if: {x: <path>, condition: [<expr>...], values: [v0.., fallback]}
    where <path> is relative (`../` to ascend) or absolute (`/a/b`), `x`
    resolves against the merged output for _only_if/_if and against the
    defaults tree for _copy;
  * a default leaf is a mapping with `_value` (which may itself be
    {_copy: <path>} resolved against the merged output);
  * keys starting with `_` are documentation (`_description`,
    `_possible_values`) and never reach the output.

Explicit user settings always win over defaults.
"""
from __future__ import annotations

import copy
import glob
import os
import re

import numpy as np

from xframe_tpu.settings.tools import DictNamespace

SETTINGS_VERSION_KEY = "settings_version"
_DEFAULT_RE = re.compile(r"default_([0-9.]+?)\.yaml$")

_SAFE_BUILTINS = {
    "abs": abs, "min": min, "max": max, "range": range, "len": len,
    "int": int, "float": float, "bool": bool, "list": list, "tuple": tuple,
    "dict": dict, "sum": sum, "round": round, "True": True, "False": False,
    "None": None,
}


def _eval_expr(expr, extra=None):
    ns = {"np": np, "numpy": np, "__builtins__": _SAFE_BUILTINS}
    if extra:
        ns.update(extra)
    return eval(expr, ns)  # noqa: S307 — sandboxed; dialect feature of the reference


def load_yaml(path):
    import yaml  # lazy: the phasing path imports this package without YAML
    with open(path) as f:
        return yaml.safe_load(f) or {}


def save_yaml(path, data):
    import yaml
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(_plain(data), f, sort_keys=False)


def _plain(data):
    if isinstance(data, DictNamespace):
        return data.dict()
    if isinstance(data, dict):
        return {k: _plain(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return [_plain(v) for v in data]
    if isinstance(data, np.ndarray):
        return data.tolist()
    if isinstance(data, np.generic):
        return data.item()
    return data


# ------------------------------------------------------------- home / folders
def home_dir() -> str:
    return os.environ.get("XFRAME_TPU_HOME",
                          os.path.join(os.path.expanduser("~"), ".xframe_tpu"))


def install_dir() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def settings_folders(project: str, worker: str) -> list:
    """Search precedence, highest first (reference 4-level precedence:
    home settings > user project dir > install tree)."""
    return [
        os.path.join(home_dir(), "settings", "projects", project, worker),
        os.path.join(home_dir(), "projects", project, "settings", worker),
        os.path.join(install_dir(), "projects", project, "settings", worker),
    ]


def experiment_settings_folders(experiment: str) -> list:
    """Per-experiment settings precedence (reference loads experiment YAML
    through the same loader as projects, startup_routines.py:249-258;
    reference layout xframe/experiments/SPB/settings/{default_0.01,name}.yaml)."""
    return [
        os.path.join(home_dir(), "settings", "experiments", experiment),
        os.path.join(home_dir(), "experiments", experiment, "settings"),
        os.path.join(install_dir(), "experiments", experiment, "settings"),
    ]


# ------------------------------------------------------------ general settings
# Survivors of the reference's general settings (reference
# settings/general.py:20-116). Obsolete-by-design keys are NOT carried:
# n_control_workers / max_parallel_processes / RAM / cache_aware / L1_cache /
# L2_cache configured the fork+OpenCL runtime that the jitted compute path
# replaced (SURVEY.md §2.8).
_GENERAL_DEFAULTS = {
    "loglevel": "WARNING",                       # reference general.py:29
    "default_project_worker_name": "ProjectWorker",      # general.py:34
    "default_experiment_worker_name": "ExperimentWorker",  # general.py:35
    "default_experiment_module_name": "experiment",       # general.py:36
    "load_projects": "all",                      # general.py:42
    "load_experiments": "all",                   # general.py:43
}


def load_general_settings():
    """General settings tree: code defaults + `<home>/settings/general.yaml`
    overrides (the reference sources a `config.py` from its home folder,
    general.py:12-18; a YAML override file keeps the same capability without
    executing user code at import). `home`/`install`/`cache_dir` are derived,
    informational entries."""
    merged = dict(_GENERAL_DEFAULTS)
    user_path = os.path.join(home_dir(), "settings", "general.yaml")
    if os.path.exists(user_path):
        user = execute_commands(load_yaml(user_path))
        if isinstance(user, dict):
            merged.update(user)
    merged["home"] = home_dir()
    merged["install"] = install_dir()
    merged.setdefault("cache_dir", os.path.join(home_dir(), "cache"))
    return DictNamespace(merged)


# --------------------------------------------------------------- file finding
def find_settings_file(folders, name):
    if name is None:
        return None
    if os.path.sep in str(name) or str(name).endswith(".yaml"):
        if os.path.exists(name):
            return name
        raise FileNotFoundError(f"settings file {name!r} not found")
    for folder in folders:
        path = os.path.join(folder, f"{name}.yaml")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"no settings file {name}.yaml in any of {folders}")


def find_default_file(folders, version=None):
    """Highest-version default_<ver>.yaml across folders (home wins ties)."""
    candidates = {}
    for folder in reversed(folders):  # later (higher-precedence) overwrite
        for path in glob.glob(os.path.join(folder, "default_*.yaml")):
            m = _DEFAULT_RE.search(os.path.basename(path))
            if m:
                candidates[m.group(1)] = path
    if not candidates:
        return None
    if version is not None and str(version) in candidates:
        return candidates[str(version)]
    return candidates[max(candidates, key=lambda v: [int(x) for x in
                                                     v.split(".") if x.isdigit()] or [0])]


# ------------------------------------------------------------------- commands
def execute_commands(tree):
    """Replace every mapping containing a `command` key by its evaluation."""
    if isinstance(tree, dict):
        if "command" in tree and isinstance(tree["command"], str):
            return _eval_expr(tree["command"])
        return {k: execute_commands(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [execute_commands(v) for v in tree]
    return tree


# ---------------------------------------------------------------- path lookup
def _resolve_path(current_path, relative_path):
    rel = str(relative_path)
    if rel.startswith("/"):
        return rel[1:].split("/")
    parts = rel.split("../")
    up = len(parts) - 1
    base = current_path[: len(current_path) - up] if up else list(current_path)
    return base + parts[-1].split("/")


def _get_value(tree, current_path, relative_path):
    node = tree
    for key in _resolve_path(current_path, relative_path):
        node = node[key]
    return node


# ----------------------------------------------------------------- directives
def _apply_directives(entry, out_root, defaults_root, path):
    """→ (entry, skip). Directive order matches the reference parser."""
    if not isinstance(entry, dict):
        return entry, False
    if "_only_if" in entry:
        spec = entry["_only_if"]
        try:
            x = _get_value(out_root, path[:-1], spec["x"])
        except (KeyError, TypeError):
            return entry, True
        if not bool(_eval_expr(str(spec["condition"]), {"x": x})):
            return entry, True
        entry = {k: v for k, v in entry.items() if k != "_only_if"}
    if "_copy" in entry:
        value = _get_value(defaults_root, path[:-1], entry["_copy"])
        return copy.deepcopy(value), False
    if "_if" in entry:
        spec = entry["_if"]
        try:
            x = _get_value(out_root, path[:-1], spec["x"])
        except (KeyError, TypeError):
            x = None
        conditions = spec["condition"]
        if not isinstance(conditions, list):
            conditions = [conditions]
        index = len(conditions)
        for i, cond in enumerate(conditions):
            if bool(_eval_expr(str(cond), {"x": x})):
                index = i
                break
        return {"_value": spec["values"][index]}, False
    return entry, False


def _default_leaf_value(entry, out_root, path):
    value = entry["_value"]
    if isinstance(value, dict) and "_copy" in value:
        return copy.deepcopy(_get_value(out_root, path[:-1], value["_copy"]))
    return value


def _is_leaf(entry):
    return (not isinstance(entry, dict)) or ("_value" in entry)


def apply_defaults(defaults, settings, out=None, path=None,
                   out_root=None, defaults_root=None):
    """Merge defaults into settings; settings values win. Directive `x` paths
    resolve against the merged output, so YAML key order matters (as in the
    reference)."""
    if out is None:
        out = copy.deepcopy(settings)
        out_root, defaults_root, path = out, defaults, []
    for key, entry in list(defaults.items()):
        if key.startswith("_") or key == SETTINGS_VERSION_KEY:
            continue
        p = path + [key]
        entry, skip = _apply_directives(entry, out_root, defaults_root, p)
        if skip:
            continue
        if key in settings:
            sub = settings[key]
            if isinstance(sub, dict) and isinstance(entry, dict) \
                    and not _is_leaf(entry):
                apply_defaults(entry, sub, out[key], p, out_root, defaults_root)
            # leaf vs leaf (or mixed): explicit setting wins — nothing to do
        else:
            if isinstance(entry, dict) and not _is_leaf(entry):
                out[key] = {}
                apply_defaults(entry, {}, out[key], p, out_root, defaults_root)
            elif isinstance(entry, dict):
                out[key] = _default_leaf_value(entry, out_root, p)
            else:
                out[key] = copy.deepcopy(entry)
    return out


# ------------------------------------------------------------------ top level
def load_project_settings(project, worker, settings_name=None, overrides=None,
                          direct_path=None):
    """→ (DictNamespace merged settings, raw merged dict for archiving)."""
    return _load_settings_tree(settings_folders(project, worker),
                               settings_name, overrides, direct_path)


def load_experiment_settings(experiment, settings_name=None, overrides=None,
                             direct_path=None):
    """Per-experiment settings through the same dialect + precedence
    (reference select_experiment, startup_routines.py:249-258; CLI `-eset`,
    main.py:61). `settings_name=None` yields the versioned defaults alone."""
    return _load_settings_tree(experiment_settings_folders(experiment),
                               settings_name, overrides, direct_path)


def _load_settings_tree(folders, settings_name=None, overrides=None,
                        direct_path=None):
    if direct_path is not None:
        settings_path = direct_path
    else:
        try:
            settings_path = find_settings_file(folders, settings_name)
        except FileNotFoundError:
            if settings_name is None:
                settings_path = None
            else:
                raise
    settings = load_yaml(settings_path) if settings_path else {}
    version = settings.get(SETTINGS_VERSION_KEY)
    default_path = find_default_file(folders, version)
    defaults = load_yaml(default_path) if default_path else {}
    if overrides:
        from xframe_tpu.settings.tools import deep_update
        deep_update(settings, _plain(overrides))

    settings = execute_commands(settings)
    defaults = execute_commands(defaults)
    merged = apply_defaults(defaults, settings)
    merged["_settings_path"] = settings_path or ""
    merged["_default_settings_path"] = default_path or ""
    merged["_settings_name"] = settings_name or ""
    raw = copy.deepcopy(merged)
    # keep the source text verbatim for comment/doc-preserving archival
    # (reference round-trips via ruamel, settings/tools.py:75-155; this
    # environment has no ruamel, so fidelity comes from archiving the
    # original bytes + the applied overrides separately)
    if settings_path:
        try:
            with open(settings_path) as f:
                raw["_settings_text"] = f.read()
        except OSError:
            pass
    if overrides:
        raw["_overrides"] = _plain(overrides)
    return DictNamespace(merged), raw


def archive_settings(run_folder, raw, prefix="settings"):
    """Write the as-run settings snapshot into a run folder:

    <prefix>.yaml        — source file BYTES verbatim (comments and
                           _description/_possible_values preserved); runtime
                           overrides appended under `_runtime_overrides`
    <prefix>_merged.yaml — the fully merged tree actually in effect
                           (settings + versioned defaults + commands), for
                           reproducibility when defaults later change

    prefix="experiment_settings" archives the experiment tree alongside the
    project one (the reference archives both, settings/__init__.py:41-58).
    """
    if not raw:
        return
    os.makedirs(run_folder, exist_ok=True)
    text = raw.get("_settings_text")
    overrides = raw.get("_overrides")
    snap = os.path.join(run_folder, f"{prefix}.yaml")
    if text is not None:
        out = text
        if overrides:
            import yaml
            out += ("\n# --- runtime overrides applied after load ---\n"
                    + yaml.safe_dump({"_runtime_overrides": _plain(overrides)},
                                     sort_keys=False))
        with open(snap, "w") as f:
            f.write(out)
    else:
        body = {k: v for k, v in raw.items() if not str(k).startswith("_")}
        if overrides:
            body["_runtime_overrides"] = _plain(overrides)
        save_yaml(snap, body)
    save_yaml(os.path.join(run_folder, f"{prefix}_merged.yaml"),
              {k: v for k, v in raw.items() if not str(k).startswith("_")})
