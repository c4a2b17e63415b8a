"""On a card, at each cell's own size: the control (the reference with
float8 products in the program's place) fails the cell's limits on three
seeds, and the program passes them. Run on a card with
`python -m pytest benchmark/tests -m cuda`."""
import tempfile

import pytest

from benchmark import calibrate, harness

CELLS = ["mofanerf.train", "mofanerf.frames", "student.viewer", "student.paths"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, card, tmp_path):
    c = harness.cell(harness.load_benchmark(), name)
    limits = c["limits"]
    seconds = 0 if c["traffic"]["runner"] == "train" else 1
    for seed in calibrate.seeds(3, 2**31 + 977):
        r = calibrate.readings(c, seed, seconds, True, card, tempfile.mkdtemp(dir=tmp_path))
        assert all(r["program"][k] <= lim for k, lim in limits.items()), r
        assert any(r["control_fp8"][k] > lim for k, lim in limits.items()), r
