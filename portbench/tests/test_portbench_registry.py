"""The harness finds a configuration, a traffic mix and a per-layer metric
that are added as new files and new entries alone, and runs the new cell."""

import json
import os
import shutil
import subprocess
import sys

from portbench import run as prun
from portbench.tests import tiny

SCRIPT = r"""
import json, sys, torch
from portbench import run
b = run.load_json(run.ROOT, "BENCHMARK.json")
cell, config, traffic, driver = run.find(b, "sr_x2_copy.tiles_tiny")
config["compute_dtype"] = "float32"
out = run.run_cell(b, "sr_x2_copy.tiles_tiny", 5, 0.2, False, torch.device("cpu"),
                   config=config, setup_t0=0.0)
ctx = {"run": {"seconds": 2.0}, "work": {"forwards": 8}}
print(json.dumps({"config": config["name"], "traffic": traffic["driver"],
                  "correct": out["correct"], "metrics": sorted(out["metrics"]),
                  "extra": run.metric_reader("forwards_per_s.tiles_tiny")(ctx),
                  "layer": [m["name"] for m in run.metrics_for(b, "sr_x2_copy.tiles_tiny", True)]}))
"""


def test_new_files_only(tmp_path):
    shutil.copytree(prun.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tiny.bench()
    cfg = json.load(open(os.path.join(prun.HERE, "configs", "sr_x2.json")))
    cfg["name"] = "sr_x2_copy"
    (tmp_path / "portbench" / "configs" / "sr_x2_copy.json").write_text(json.dumps(cfg))
    _, traffic = tiny.cell("sr_x2.tiles")
    (tmp_path / "portbench" / "traffic" / "tiles_tiny.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench" / "metrics" / "forwards_per_s.tiles_tiny.py").write_text(
        "def read(ctx):\n    return ctx['work']['forwards'] / ctx['run']['seconds']\n")
    bench["configs"].append(dict(bench["configs"][0], name="sr_x2_copy",
                                 file="portbench/configs/sr_x2_copy.json"))
    bench["workloads"].append({"name": "sr_x2_copy.tiles_tiny", "config": "sr_x2_copy",
                               "traffic": "tiles_tiny", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "tiles_per_s":
            m["workloads"].append("sr_x2_copy.tiles_tiny")
    bench["per_layer"].append({"name": "forwards_per_s.tiles_tiny", "unit": "1/s",
                               "better": "higher", "source": "program_counter", "layer": "ops",
                               "moves": "tiles_per_s", "workloads": ["sr_x2_copy.tiles_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=prun.ROOT)
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["config"] == "sr_x2_copy" and got["traffic"] == "tiles"
    assert got["correct"] is True
    assert got["metrics"] == ["setup_s", "tiles_per_s"]
    assert got["extra"] == 4.0
    assert "forwards_per_s.tiles_tiny" in got["layer"]
