"""Settings dialect unit tests: versioned defaults, command eval, directives."""
import os

import numpy as np
import pytest

from xframe_tpu.settings.loader import (
    apply_defaults, execute_commands, find_default_file, load_project_settings)
from xframe_tpu.settings.tools import DictNamespace


def test_command_eval_sandboxed():
    tree = {"a": {"command": "np.arange(3) * 2"},
            "b": {"nested": {"command": "[1, 2] + [3]"}}, "c": 5}
    out = execute_commands(tree)
    assert np.array_equal(out["a"], [0, 2, 4])
    assert out["b"]["nested"] == [1, 2, 3]
    assert out["c"] == 5
    with pytest.raises(Exception):
        execute_commands({"x": {"command": "__import__('os').system('true')"}})


def test_apply_defaults_fills_and_respects_settings():
    defaults = {
        "a": {"_value": 1},
        "b": {"sub": {"_value": "x"}, "other": {"_value": 2.5}},
        "_doc": "ignored",
    }
    settings = {"b": {"sub": "user"}}
    out = apply_defaults(defaults, settings)
    assert out["a"] == 1
    assert out["b"]["sub"] == "user"
    assert out["b"]["other"] == 2.5
    assert "_doc" not in out


def test_only_if_directive():
    defaults = {
        "mode": {"_value": "fast"},
        "fast_opts": {"_only_if": {"x": "mode", "condition": 'x=="fast"'},
                      "level": {"_value": 3}},
        "slow_opts": {"_only_if": {"x": "mode", "condition": 'x=="slow"'},
                      "level": {"_value": 9}},
    }
    out = apply_defaults(defaults, {})
    assert out["fast_opts"]["level"] == 3
    assert "slow_opts" not in out


def test_copy_and_if_directives():
    defaults = {
        "radius": {"_value": 100},
        "guess_radius": {"_value": {"_copy": "/radius"}},
        "flavor": {"_value": "b"},
        "derived": {"_if": {"x": "flavor",
                            "condition": ['x=="a"', 'x=="b"'],
                            "values": [1, 2, 0]}},
    }
    out = apply_defaults(defaults, {"radius": 250})
    assert out["guess_radius"] == 250  # resolves against the MERGED output
    assert out["derived"] == 2
    out2 = apply_defaults(defaults, {"flavor": "zzz"})
    assert out2["derived"] == 0  # fallback value


def test_versioned_default_selection(tmp_path):
    d = tmp_path / "w"
    d.mkdir()
    (d / "default_0.1.yaml").write_text("v:\n  _value: 1\n")
    (d / "default_0.2.yaml").write_text("v:\n  _value: 2\n")
    assert find_default_file([str(d)]).endswith("default_0.2.yaml")
    assert find_default_file([str(d)], version="0.1").endswith("default_0.1.yaml")


def test_dictnamespace_shadowing():
    ns = DictNamespace({"values": [1, 2], "keys": "data-key", "normal": 7})
    assert ns.values == [1, 2]      # data shadows the mapping method
    assert ns.keys == "data-key"
    assert ns["normal"] == 7
    ns2 = DictNamespace({"a": {"b": 1}})
    assert ns2.a.b == 1
    assert list(ns2.items()) == [("a", ns2.a)]
    assert ns2.get("missing", "d") == "d"


def test_home_settings_precedence(tmp_path, monkeypatch):
    monkeypatch.setenv("XFRAME_TPU_HOME", str(tmp_path))
    d = tmp_path / "settings" / "projects" / "fxs" / "reconstruct"
    d.mkdir(parents=True)
    (d / "mine.yaml").write_text("structure_name: custom\n"
                                 "particle_radius: 42\n")
    ns, raw = load_project_settings("fxs", "reconstruct", "mine")
    assert ns.structure_name == "custom"
    assert ns.particle_radius == 42
    # defaults still merged from the install tree
    assert ns.grid.n_radial_points == 128
    assert ns.density_guess.radius == 42  # _copy picks up the override


def test_archival_preserves_comments_and_doc_fields(tmp_path, monkeypatch):
    """Archived settings.yaml byte-compares to the source file (comments and
    _description fields intact); runtime overrides are recorded alongside;
    settings_merged.yaml carries the full in-effect tree (VERDICT r2 #10)."""
    import os
    import yaml as _yaml
    from xframe_tpu.settings import loader
    home = tmp_path / "home"
    folder = home / "settings" / "projects" / "demo" / "work"
    folder.mkdir(parents=True)
    src = """\
# tuning for the pytest run — keep me
structure_name: pytest   # inline comment
grid:
  n_radial_points: 8     # coarse on purpose
_description: archival fidelity fixture
"""
    (folder / "t.yaml").write_text(src)
    (folder / "default_0.1.yaml").write_text(
        "grid:\n  max_order: {_value: 4}\n")
    monkeypatch.setenv("XFRAME_TPU_HOME", str(home))

    ns, raw = loader.load_project_settings("demo", "work", "t")
    run_folder = tmp_path / "run_1"
    loader.archive_settings(str(run_folder), raw)
    assert (run_folder / "settings.yaml").read_text() == src   # byte-equal
    merged = _yaml.safe_load((run_folder / "settings_merged.yaml").read_text())
    assert merged["grid"]["max_order"] == 4       # defaults are in the merge
    assert merged["grid"]["n_radial_points"] == 8

    # with overrides: source text intact + overrides appended, parseable
    ns2, raw2 = loader.load_project_settings(
        "demo", "work", "t", overrides={"grid": {"n_radial_points": 16}})
    run2 = tmp_path / "run_2"
    loader.archive_settings(str(run2), raw2)
    text = (run2 / "settings.yaml").read_text()
    assert text.startswith(src)
    assert "# tuning for the pytest run" in text
    reparsed = _yaml.safe_load(text)
    assert reparsed["_runtime_overrides"]["grid"]["n_radial_points"] == 16
    merged2 = _yaml.safe_load((run2 / "settings_merged.yaml").read_text())
    assert merged2["grid"]["n_radial_points"] == 16
    del os


def test_shipped_reconstruct_defaults_match_measured_optima():
    """The shipped reconstruct defaults name only settings that still act:
    no key of a removed feature (fused kernels, replay best tracking), a
    plain-path procrustes method, and no device timing quoted in any
    description (the numbers belong with the hardware they were taken on,
    in PERF.md)."""
    import re
    from xframe_tpu.settings.loader import load_yaml
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "xframe_tpu", "projects", "fxs", "settings", "reconstruct",
        "default_0.1.yaml")
    raw = load_yaml(path)
    assert raw["multi_start"]["batch_size"]["_value"] == 2
    assert "fused_sht" not in raw["fourier_transform"]
    assert "fused_bf16_tables" not in raw["fourier_transform"]
    assert "best_tracking" not in raw["main_loop"]
    pm = raw["projections"]["reciprocal"]["procrustes_method"]
    assert pm["_value"] == "newton_schulz"
    assert set(pm["_possible_values"]) == {"newton_schulz", "svd"}

    def descriptions(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "_description":
                    yield str(v)
                else:
                    yield from descriptions(v)

    for d in descriptions(raw):
        assert not re.search(r"\d s/|ms/iter|measured|\bTPU\b|MXU", d), d
