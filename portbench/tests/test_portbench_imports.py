"""Nothing that ``portbench.run`` loads is JAX or the JAX package, top-level
module names compared whole (the port's name begins with the JAX
package's); the plain reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from portbench import run as prun

RUN = r"""
import json, sys
from portbench.tests import tiny
out = tiny.run("sr_x2.tiles")
print(json.dumps({"correct": out["correct"], "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""

REFERENCE = r"""
import json, sys
import portbench.reference.unet, portbench.reference.sampling, portbench.reference.blend
import portbench.reference.downblur, portbench.reference.train, portbench.reference.precision
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top(script):
    r = subprocess.run([sys.executable, "-c", script], cwd=prun.ROOT, capture_output=True,
                       text=True, timeout=600, env=dict(os.environ, PYTHONPATH=prun.ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    got = _top(RUN)
    assert got["correct"] is True
    assert "diffusionremotesensing_tpu_torch" in got["top"]
    assert not set(got["top"]) & set(prun.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = set(_top(REFERENCE))
    assert not top & set(prun.FORBIDDEN)
    assert "diffusionremotesensing_tpu_torch" not in top


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "diffusionremotesensing_tpu_torch_lookalike", sys)
    assert "diffusionremotesensing_tpu" not in prun.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax", sys)
    assert prun.forbidden_modules() == ["flax"]
