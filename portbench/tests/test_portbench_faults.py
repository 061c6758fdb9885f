"""The check fails what it must: a run with the timed path broken
underneath (each fault of ``portbench.faults`` the cell can have) comes
out not correct, and a sound run at the same size comes out correct.
CPU size, the cells' own limits; the harness's look for a chip is
skipped (``device="cpu"``)."""
import pytest
import torch

from conftest import tiny_spec
from portbench import harness
from portbench.control import control_readings
from portbench.faults import FAULTS, plant
from portbench.yardstick.spans import Spans

CELLS = ["fl_lora.smollm-360m", "fedsgd.smollm-360m", "prefill.smollm-360m"]
CASES = [(c, f) for c in CELLS
         for f in FAULTS[tiny_spec(c).traffic["driver"]]]


def _run(spec, seed=2**31 + 3):
    return harness.run(spec, seed, 0.3, False, device="cpu")


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = _run(tiny_spec(workload))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault):
    spec = tiny_spec(workload)
    with plant(spec.traffic["driver"], fault):
        r = _run(spec)
    assert not r["correct"], (fault, r["checks"])


def _control(workload):
    """A sound bf16 run's readings and the control's, at CPU size."""
    spec = tiny_spec(workload, dtype="bfloat16")
    drv = harness.driver_class(spec)(spec, 12345, torch.device("cpu"),
                                     Spans(), 0.3)
    drv.setup()
    drv.window(0.3)
    drv.release()
    return spec, dict(drv.check()), dict(control_readings(drv))


@pytest.mark.parametrize("workload", CELLS)
def test_control_separates(workload):
    """The control (the reference in the precision below the
    configuration's, in the program's place) reads at least three times
    what a sound bf16 run reads on one of the cell's numbers."""
    _, prog, ctl = _control(workload)
    assert any(ctl[k] >= 3 * max(prog[k], 1e-6) for k in ctl), (prog, ctl)


# The served logit gap grows with depth and width: at CPU size the
# control reads under the prefill cell's limit, which control.py shows
# it failing at the cell's own size on the card.
@pytest.mark.parametrize("workload", ["fl_lora.smollm-360m",
                                      "fedsgd.smollm-360m"])
def test_control_is_not_correct_under_the_cells_limits(workload):
    """The harness's own comparison, with the cell's limits, finds the
    control not correct."""
    spec, _, ctl = _control(workload)
    correct, compared = harness.judge(list(ctl.items()), spec.limits)
    assert not correct, compared
