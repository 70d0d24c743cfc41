"""BENCHMARK.json keeps to the format and the limits its readers expect,
and every name in it has its file: a configuration, a traffic mix, a
metric's reader, a cell's limits."""
import json
import re

import pytest

from bench.lib import adapter, family, manifest, traffic

MAN = manifest.load()
ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and ".." not in p and (ROOT / p).is_dir()
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    for w in MAN["command"]:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p.rstrip("/") + "/") for p in MAN["paths"])


def test_run_seconds_fit_twenty_four_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = MAN[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert _line(e[k]), (e["name"], k)


def test_configs_and_cells():
    cfgs = {c["name"]: c for c in MAN["configs"]}
    assert 1 <= len(cfgs) <= 24 and 1 <= len(MAN["workloads"]) <= 24
    used = set()
    for c in MAN["configs"]:
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        raw = json.loads((ROOT / c["file"]).read_text())
        assert raw["source"] == c["source"] and raw["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert k in raw["published"]
            assert not re.search(r"(size|_dim|_rank|heads|experts_per|num_experts)", k)
    pairs = set()
    for w in MAN["workloads"]:
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "bench" / "limits" / f"{w['name']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(cfgs)
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("config", sorted((ROOT / "bench" / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_config_names_its_family_by_file(config):
    """A configuration's ``reference`` key names its family's module; the
    family's cost arithmetic and program mapping sit beside it by name."""
    fam = family.load(config)
    for part in ("reference", "costs", "program"):
        assert (ROOT / "bench" / part / f"{fam.name}.py").is_file()
    assert callable(fam.reference.Reference) and callable(fam.reference.shapes)
    assert fam.arch.layers > 0 and fam.arch.dtype in ("bfloat16", "float16", "float32")


@pytest.mark.parametrize("mix", sorted((ROOT / "bench" / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_mix_names_an_adapter_by_file(mix):
    entry = traffic.load(mix)["entry"]
    assert (ROOT / "bench" / "adapters" / f"{entry}.py").is_file()
    mod = adapter.load(entry)
    assert issubclass(mod.Adapter, adapter.Base) and callable(mod.plant_fault)
    for name in ("check", "control", "end_to_end", "attempted_failed", "call"):
        assert callable(getattr(mod.Adapter, name))


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_metrics_per_cell():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])
    for w in MAN["workloads"]:
        mine = [m for m in MAN["end_to_end"] if _reports(m, w["name"])]
        assert {"setup_s"} < {m["name"] for m in mine}
        assert any(_reports(m, w["name"]) for m in MAN["per_layer"])
