"""BENCHMARK.json against the contract's shape, and discovery of every
file a cell, a configuration, a traffic mix or a per-layer metric needs by
name, including a cell added as new files only."""

import json
import re
import shutil
from pathlib import Path

import pytest

from perf_bench.manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_shape(bench):
    assert set(bench) == TOP_KEYS
    assert bench["command"] == ["python3", "perf_bench/run.py"]
    assert bench["paths"] == ["perf_bench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_and_names(bench):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, required in keys.items():
        names = [e["name"] for e in bench[section]]
        assert len(names) == len(set(names)), section
        for e in bench[section]:
            assert required <= set(e) <= required | {"workloads"}, (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in bench["configs"]} == {w["config"] for w in bench["workloads"]}


def test_metrics_contract(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    layers = {}
    for m in bench["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in cells:  # every cell reports a per-layer metric
        assert any(w in m.get("workloads", cells) for m in bench["per_layer"])


def test_every_file_is_found_by_name(bench):
    m = Manifest(ROOT)
    for w in bench["workloads"]:
        cell = m.workload(w["name"])
        conf = m.config(cell["config"])
        assert {"settings", "sensor", "control", "assumed", "guarantees"} <= set(conf)
        traffic = m.traffic(cell["traffic"])
        assert traffic["lap"]["kind"] == "orbit"
        assert m.limits(w["name"])
        for c in bench["configs"]:
            assert (ROOT / c["file"]).is_file() and c["file"].startswith("perf_bench/")
    for metric in bench["per_layer"]:
        assert callable(m.layer_reader(metric["name"]))


def test_a_cell_added_as_new_files_only(tmp_path, bench):
    """A new configuration, traffic mix, cell, limits file and per-layer
    metric take only new files and new entries in BENCHMARK.json."""
    shutil.copytree(ROOT / "perf_bench", tmp_path / "perf_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    b = json.loads(json.dumps(bench))
    src = json.loads((ROOT / "perf_bench/configs/tum1-rgbd.json").read_text())
    src["settings"]["DepthMapFactor"] = 5208.0
    (tmp_path / "perf_bench/configs/tum2-rgbd.json").write_text(json.dumps(src))
    (tmp_path / "perf_bench/traffic/slow-pan.json").write_text(json.dumps(
        {**m_traffic(), "lap": {"kind": "orbit", "lap_frames": 480, "radius_m": 0.1,
                                "yaw_amp_rad": 0.3, "fps": 30.0}}))
    (tmp_path / "perf_bench/limits/tum2-rgbd.slow-pan.json").write_text('{"ate_cm": 1.0}')
    (tmp_path / "perf_bench/layer_metrics/frames_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['frames'])\n")
    b["configs"].append({"name": "tum2-rgbd", "source": "https://example.org/TUM2.yaml",
                         "file": "perf_bench/configs/tum2-rgbd.json", "reduced": [],
                         "why": "fr2 depth scale"})
    b["workloads"].append({"name": "tum2-rgbd.slow-pan", "config": "tum2-rgbd",
                           "traffic": "slow-pan", "chips": 1, "why": "a slow pan"})
    b["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                           "source": "host_clock", "layer": "host loop",
                           "moves": "frame_ms_p95",
                           "workloads": ["tum2-rgbd.slow-pan"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    m = Manifest(tmp_path)
    cell = m.workload("tum2-rgbd.slow-pan")
    assert m.config(cell["config"])["settings"]["DepthMapFactor"] == 5208.0
    assert m.traffic(cell["traffic"])["lap"]["lap_frames"] == 480
    assert m.limits("tum2-rgbd.slow-pan") == {"ate_cm": 1.0}
    names = [x["name"] for x in m.metrics_for("per_layer", "tum2-rgbd.slow-pan")]
    assert "frames_seen" in names and "kf_step_ms" not in names
    assert m.layer_reader("frames_seen")({"frames": 7}) == 7.0
    assert "frames_seen" not in [x["name"] for x in m.metrics_for("per_layer",
                                                                 "tum1-rgbd.mapping")]


def m_traffic():
    return json.loads((ROOT / "perf_bench/traffic/localize.json").read_text())
