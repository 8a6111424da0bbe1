"""The comparison that decides ``correct`` fails what it must, on the CPU
at the tiny size: the control (the reference at the precision below the
configuration's, in the program's place) and a run with the timed path
broken underneath by each fault the cells can have (a step that leaves its
state unchanged, half of the batch left out, an answer altered where it
is produced, and in the pose cell the gradient's joints out of order).
Each drives a run's set-up, checked steps, warm-up, window steps and
check, the harness's look for a card left out, and its limits are the
cell's own."""

import pytest

from benchmark.harness import compare, faults
from benchmark.reference.precision import Precision
from benchmark.tests import tiny

CONTROL = {"train_clip": "fp8", "pose_adam": "tf32"}


def failed(checks: dict) -> bool:
    return any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("driver", ["train_clip", "pose_adam"])
def test_the_program_passes_its_limits(driver):
    d, _ = tiny.run_driver(driver, 2**31 + 3)
    assert not failed(d.check())


@pytest.mark.parametrize("driver", ["train_clip", "pose_adam"])
def test_the_control_fails(driver):
    d, _ = tiny.run_driver(driver, 2**31 + 3)
    ref = d.reference()
    low = d.reference(Precision(CONTROL[driver]))
    assert failed(compare.checks(compare.readings(low, ref), d.wl["limits"]))


@pytest.mark.parametrize("driver,fault", [(d, f) for d in ("train_clip", "pose_adam")
                                          for f in sorted(faults.for_driver(d))])
def test_a_fault_under_the_timed_path_fails(driver, fault):
    with faults.FAULTS[fault]():
        d, _ = tiny.run_driver(driver, 2**31 + 3)
    assert failed(d.check())
