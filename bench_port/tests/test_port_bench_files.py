"""BENCHMARK.json and every data file the harness finds by name: they load,
name only known keys, and keep to BENCHMARK.json's characters and sizes."""

import json
import re

import pytest

from bench_port.cell import HERE, ROOT, load_benchmark, load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]

CONFIG_KEYS = {"name", "source", "defined_in", "reference", "arch",
               "sampling_rate", "segment_length", "hop_length",
               "hidden_dims", "latent_dim", "kl_beta", "learning_rate",
               "b1", "b2", "eps", "batch_size", "loss_reduction", "program",
               "set", "reduced"}
TRAFFIC_KEYS = {"name", "engine", "corpus", "why", "assumed", "program"}
CELL_KEYS = {"control", "limits"}
LIMITS = {"loss_gap", "window_loss_gap", "grad_gap", "change_gap",
          "change_median"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and all(map(_line, BENCH["command"]))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert _line(entry[key]), (entry["name"], key)
    assert len(names) == len(set(names))


def test_metrics_refer_to_what_exists():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_with_known_keys(cell):
    c = load_cell(cell)
    assert set(c.config) <= CONFIG_KEYS
    assert set(c.traffic) <= TRAFFIC_KEYS
    assert set(c.spec) == CELL_KEYS
    assert set(c.spec["limits"]) == LIMITS
    assert set(c.spec["control"]) == {"rounding"}
    assert c.chips == 1
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert _line(entry["why"])
    assert c.traffic["name"] == entry["traffic"]
    assert c.config["name"] == entry["config"]


@pytest.mark.parametrize("conf", BENCH["configs"])
def test_config_entries(conf):
    path = ROOT / conf["file"]
    assert path.is_relative_to(HERE) and path.is_file()
    data = json.loads(path.read_text())
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    assert set(data["reduced"]) <= set(data["set"])
    assert (HERE / "reference" / f"{data['reference']}.py").is_file()
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
