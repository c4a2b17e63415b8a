"""The frozen arithmetic gives the figures the port's measurements were
reported against (chip_smoke.py's, in PERF.md)."""
import json

import pytest

from benchmark import counts, harness


def _teacher():
    with open(harness.ROOT / "benchmark" / "configs" / "mofanerf.json") as f:
        return json.load(f)


@pytest.mark.parametrize("width,depth,mflop", [(1024, 10, 53.6), (256, 8, 2.85)])
def test_field_flops_a_point(width, depth, mflop):
    f = counts.field_flops_per_point(width, 10, counts.field_layers(depth))
    assert f / 1e6 == pytest.approx(mflop, rel=2e-3)


def test_serve_flops_a_sample():
    assert counts.student_flops_per_sample(4, 128, 8) == 161_152


def test_train_step_bound():
    assert counts.train_step_bound_s(_teacher()) * 1e3 == pytest.approx(21.93, abs=0.005)


def test_field_launch_bound_is_operations_bound_at_the_fine_packet():
    b = counts.field_launch_bound_s(1024, 10, 10, 8192, 128)
    assert b * 1e3 == pytest.approx(56.84, abs=0.01)
