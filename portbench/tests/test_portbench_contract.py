"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files and bounds; and the result line's keys from a run on the CPU."""

import json
import os
import re

import pytest

from portbench import run as prun
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return tiny.bench()


def test_keys(bench):
    assert set(bench) == KEYS["top"]
    for c in bench["configs"]:
        assert set(c) == KEYS["config"]
    for w in bench["workloads"]:
        assert set(w) == KEYS["workload"]
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"]
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"]
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    names = ([c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in bench["workloads"]] + [c["why"] for c in bench["configs"]]
                 + [c["source"] for c in bench["configs"]] + bench["command"]
                 + [m["layer"] for m in bench["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_cells_and_metrics(bench):
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(prun.HERE, "traffic", f"{w['traffic']}.json"))
        reported = [m for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert prun.metrics_for(bench, w["name"], True)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(prun.HERE, "metrics", f"{m['name']}.py"))
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(prun.ROOT, c["file"]))
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51


def test_result_line_keys():
    out = tiny.run("gen_eurosat10.bulk")
    out.pop("_summary")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["metrics"]) == {"sampled_images_per_s", "setup_s"}


def test_no_card_no_result(capsys):
    """Without a CUDA card a run fails and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert prun.main(["--workload", "sr_x2.tiles", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
