"""A run with the timed path broken underneath reads ``correct`` false,
once for each fault a cell can have (``faults.CELL_FAULTS``); the sound
run reads it true. Each cell at its tiny size on the CPU (the harness's
look for a card skipped)."""

import pytest

from portbench import faults
from portbench import run as prun
from portbench.tests import tiny

CASES = [(w, f) for w in tiny.TINY
         for f in faults.CELL_FAULTS[prun.find(tiny.bench(), w)[2]["driver"]]]


@pytest.mark.parametrize("workload", list(tiny.TINY))
def test_sound_run_is_correct(workload):
    assert tiny.run(workload)["correct"] is True


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_caught(workload, fault):
    driver = prun.find(tiny.bench(), workload)[2]["driver"]
    with faults.FAULTS[fault](driver):
        out = tiny.run(workload)
    assert out["correct"] is False, out["checks"]


def test_ema_left_in_its_warm_up_is_caught(monkeypatch):
    """The train cell's steps are past the EMA's warm-up: an EMA that only
    copies the parameters, as in the warm-up, reads ``correct`` false."""
    from diffusionremotesensing_tpu_torch import train as ptrain

    update = ptrain.ema_update
    monkeypatch.setattr(ptrain, "ema_update", lambda ema, params, step, beta, warmup:
                        update(ema, params, 0, beta, warmup))
    checks = tiny.run("sr_x2.train")["checks"]
    assert checks["ema_gap"]["value"] > checks["ema_gap"]["limit"], checks


def test_forward_a_little_wrong_is_caught(monkeypatch):
    """A forward 5% off, which the clamped tiles barely show, fails the
    tiles cell's ``eps_gap``."""
    from diffusionremotesensing_tpu_torch.models import unet as punet

    forward = punet.ResidualAttentionUNet.forward
    monkeypatch.setattr(punet.ResidualAttentionUNet, "forward",
                        lambda self, *a, **kw: forward(self, *a, **kw) * 1.05)
    checks = tiny.run("sr_x2.tiles")["checks"]
    assert checks["eps_gap"]["value"] > checks["eps_gap"]["limit"], checks
