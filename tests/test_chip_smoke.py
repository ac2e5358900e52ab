"""chip_smoke.py refuses to run without a GPU, and its result line has the
exact contract: one JSON object {"ok": true, "device": {platform, kind,
count}} as the last line of standard output."""
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_cpu_only_run(tmp_path, where):
    """On the CPU (and in a directory holding chip_smoke.py and nothing
    else of the repo) the script exits nonzero and prints no ok line."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd, env["PYTHONPATH"] = str(tmp_path), ""
    else:
        cwd = ROOT
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_last_line_contract(monkeypatch, capsys):
    """With every phase passing, the last stdout line is exactly the JSON
    result and every earlier line starts with the card line."""
    sys.path.insert(0, ROOT)
    import jax
    import chip_smoke
    from xframe_tpu.library import device
    monkeypatch.setattr(device, "require_gpu", lambda: jax.devices())
    monkeypatch.setattr(device, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    for name in ("device", "phasing_tutorial", "phasing_production",
                 "check_a", "check_b", "check_c", "worker_pipeline"):
        monkeypatch.setattr(chip_smoke.Smoke, name, lambda self: None)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert chip_smoke.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"ok", "device"} and last["ok"] is True
    assert set(last["device"]) == {"platform", "kind", "count"}
    d0 = jax.devices()[0]
    assert last["device"] == {"platform": d0.platform,
                              "kind": d0.device_kind, "count": 1}
    assert all(ln.startswith("[NVIDIA H100 80GB HBM3, 700.00 W]")
               for ln in lines[:-1])
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in lines[-2]


@pytest.mark.parametrize("outcome", ["ok", "not run", "failed"])
def test_phase_reports_its_outcome(capsys, outcome):
    """A phase that returns NotRun is reported as not run — never as ok —
    and only a raising phase is counted as failed."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    def fn():
        if outcome == "not run":
            return chip_smoke.NotRun("module 'h5py' is not installed")
        if outcome == "failed":
            raise AssertionError("bound exceeded")

    smoke = chip_smoke.Smoke("card")
    smoke.phase("worker pipeline", fn)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[card] worker pipeline: {outcome.upper()}"
                           if outcome == "failed" else
                           f"[card] worker pipeline: {outcome}")
    assert smoke.failed == (["worker pipeline"] if outcome == "failed"
                            else [])
    if outcome == "not run":
        assert "h5py" in line and ": ok" not in line
