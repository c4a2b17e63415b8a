"""The plain references agree with the port on the CPU at tiny sizes when
the port computes in f32, and the references import nothing of the port."""
import ast
import tempfile

import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny_cell

CELLS = ["mofanerf.train", "mofanerf.frames", "student.viewer", "student.paths"]


def _sample(name, tmp_path, dtype="float32", seed=2**31 + 3):
    c = tiny_cell(name)
    c["config"]["compute_dtype"] = dtype
    drv = harness.runner_class(c["traffic"])(c["config"], c["traffic"], seed, "cpu",
                                             tempfile.mkdtemp(dir=tmp_path))
    harness.measure(drv, 0.2)
    return drv, drv.collect()


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_port_in_f32(name, tmp_path):
    drv, sample = _sample(name, tmp_path)
    numbers = drv.numbers(sample, "program")
    # Adam's first steps divide a gradient by its own magnitude: where it is
    # near eps the f32 sums' order moves a leaf's change by ~1e-3
    limited = [numbers[k] for k in tiny_cell(name)["limits"]]
    assert max(limited) < (5e-3 if name == "mofanerf.train" else 1e-4), numbers


def test_reference_imports_nothing_of_the_program():
    for path in (harness.ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "benchmark", "__future__",
                                           "contextlib", "math"), (path.name, n)
                assert not n.startswith("benchmark.") or n.startswith("benchmark.reference"), \
                    (path.name, n)
