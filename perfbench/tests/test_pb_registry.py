"""BENCHMARK.json against the contract's character rules, every cell,
configuration and metric found by name, and a cell added by files alone."""

import json
import os
import re

import pytest

import pb_helpers
from perfbench.lib import core

BENCH = core.load_json(os.path.join(core.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_keys_and_bounds():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_found_by_name(cell):
    c = core.Cell(cell)
    assert c.entry_module().Driver and c.traffic_module()
    readers = c.metric_readers()
    assert readers and all(callable(r.read) for r in readers.values())
    assert c.config["name"] == c.entry["config"]
    assert any(m["name"] != "setup_s" for m in c.end_to_end) and any(m["name"] == "setup_s" for m in c.end_to_end)
    for m in c.per_layer:  # a per-layer metric's cell reports what it moves
        assert m["moves"] in {e["name"] for e in c.end_to_end}
    assert c.chips == 1


def test_config_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        cfg = core.load_json(os.path.join(core.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A new configuration, traffic file, workload and metric, with no edit
    to any file the harness has, run end to end on the CPU."""
    root = pb_helpers.tiny_copy(tmp_path, pb_helpers.TINY_TRAFFIC)
    pkg = os.path.join(root, "perfbench")
    before = {p: open(os.path.join(dp, p), "rb").read() for dp, _, fs in os.walk(pkg) for p in fs if p.endswith(".py")}
    cfg = core.load_json(os.path.join(pkg, "configs", "stabletts-v1.1-vocos44k-serve.json"))
    cfg["name"] = "dummy-config"
    cfg["n_timesteps"] = 1
    json.dump(cfg, open(os.path.join(pkg, "configs", "dummy-config.json"), "w"))
    wl = core.load_json(os.path.join(pkg, "workloads", "serve_batch_bf16.json"))
    wl["traffic"]["batch"] = 2
    json.dump(wl, open(os.path.join(pkg, "workloads", "dummy_cell.json"), "w"))
    open(os.path.join(pkg, "metrics", "dummy_frames.count.py"), "w").write(
        "def read(ctx):\n    return float(ctx['work']['valid_frames'])\n")
    bench = core.load_json(os.path.join(root, "BENCHMARK.json"))
    bench["configs"].append(dict(bench["configs"][0], name="dummy-config", file="perfbench/configs/dummy-config.json"))
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy-config", "traffic": "dummy", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_audio_s_per_s":
            m["workloads"].append("dummy_cell")
    bench["per_layer"].append({"name": "dummy_frames.count", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "sampler", "moves": "serve_audio_s_per_s",
                               "workloads": ["dummy_cell"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    run = core.load_module(os.path.join(pkg, "run.py"), "pb_run_dummy")
    cell = core.Cell("dummy_cell", root)
    res = run.run(cell, 5, 0.5, False, "cpu")
    assert res["correct"] and res["metrics"]["serve_audio_s_per_s"]["value"] > 0
    res = run.run(cell, 5, 0.5, True, "cpu")
    assert res["metrics"]["dummy_frames.count"]["value"] > 0
    after = {p: open(os.path.join(dp, p), "rb").read() for dp, _, fs in os.walk(pkg) for p in fs
             if p.endswith(".py") and p in before}
    assert after == before
