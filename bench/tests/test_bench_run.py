"""A whole run of each cell at smoke size on the CPU (the look for a card
skipped): the result line's keys, ``correct`` true; with a fault planted
in the timed path, ``correct`` false; no JAX module loaded; and
``run.py`` itself refusing to run without a card."""
import json
import subprocess
import sys
import time

import pytest
import torch

import repro_torch
from bench.lib import adapter as adapter_mod
from bench.lib import cell as cell_mod
from bench.lib import manifest
from bench.tests import smoke

MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]


@pytest.fixture(autouse=True)
def _cpu():
    repro_torch.set_device("cpu")
    yield
    repro_torch.set_device(None)


def _run(name, seed=2**31 + 17):
    c = manifest.cell(MAN, name)
    return cell_mod.run(MAN, c, seed=seed, seconds=0.5, trace=False,
                        device=torch.device("cpu"), t_start=time.perf_counter(),
                        fam=smoke.family_of(c["config"]), mix=smoke.mix(c))


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name):
    out = _run(name)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in MAN["end_to_end"] if name in m.get("workloads", [name])}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_or_token_is_not_correct(name):
    undo = adapter_mod.load(cell_mod.mix_of(manifest.cell(MAN, name))["entry"]).plant_fault()
    try:
        out = _run(name)
    finally:
        undo()
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(manifest.ROOT / "bench"))
    import run as run_mod
    for name in ("jax", "jaxlib.xla_client", "flax", "repro", "repro.core"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name in run_mod.loaded_forbidden()
        monkeypatch.delitem(sys.modules, name)
    assert "repro_torch" in sys.modules and run_mod.loaded_forbidden() == []


def test_a_cpu_run_loads_no_jax():
    _run(CELLS[0])
    assert not {m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "repro"}


def test_run_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1"], cwd=manifest.ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    with pytest.raises(json.JSONDecodeError):
        json.loads(proc.stdout or "x")


@pytest.mark.parametrize("name", CELLS)
def test_calibration_readings_at_smoke_size(name):
    """The readings go through the same set-up and the same verdict as a
    run: the program is correct, and the float8 control, judged by the
    cell's limits, is not (at smoke widths as at the cell's own)."""
    from bench.calibrate import readings
    c = manifest.cell(MAN, name)
    r = readings(name, 2**31 + 5, device=torch.device("cpu"),
                 fam=smoke.family_of(c["config"]), mix=smoke.mix(c))
    assert r["program_correct"] is True
    assert r["control_correct"] is False
