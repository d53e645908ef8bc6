"""On the card (marked ``chip``; skipped on the CPU): each cell's control,
the plain reference in float8 e4m3 in the program's place, at the cell's
own size, fails a limit that the program's own run holds; and one run of
the command prints the result line the contract asks for.

    python3 -m pytest -q portbench/tests -m chip -p no:cacheprovider
"""

import json
import subprocess
import sys

import pytest

from portbench import control
from portbench import run as prun
from portbench.tests import tiny

WORKLOADS = [w["name"] for w in tiny.bench()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_where_the_program_holds(card, workload):
    traffic = prun.find(tiny.bench(), workload)[2]
    (row,) = control.readings(workload, [2**31 + 5], 1.0, device=card)
    limits = traffic["limits"]
    assert all(v <= limits[k] for k, v in row["program"].items()), row
    assert any(v > limits[k] for k, v in row["control"].items()), row


@pytest.mark.chip
@pytest.mark.parametrize("workload", WORKLOADS)
def test_command_prints_the_result_line(card, workload):
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                        "--seed", str(2**31 + 9), "--seconds", "2", "--trace", "1"],
                       cwd=prun.ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert set(out["metrics"]) <= {m["name"] for m in prun.metrics_for(tiny.bench(), workload, True)}
