"""run.py refuses to measure without a card, and nothing it loads is JAX or
the JAX package (top-level module names compared whole)."""
import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT


def test_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "student.viewer",
                        "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "needs 1 CUDA card" in p.stderr


REHEARSAL = r"""
import json, sys, tempfile
sys.path.insert(0, ".")
import benchmark.run
from benchmark import calibrate, harness
from benchmark.tests.tiny import tiny_cell
for name in ("mofanerf.train", "mofanerf.frames", "student.viewer", "student.paths"):
    for trace in (False, True):
        harness.run(tiny_cell(name), 7, 0.1, trace, 0.0, "cpu", tempfile.mkdtemp())
    for m in harness.cell(harness.load_benchmark(), name)["per_layer"]:
        harness.metric_reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_in_the_process():
    env = dict(os.environ, TMPDIR=os.environ.get("TMPDIR", "/tmp"))
    p = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=ROOT, capture_output=True,
                       text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "mofanerf_tpu_torch" in loaded
    assert not loaded & harness.FORBIDDEN, loaded & harness.FORBIDDEN


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mofanerf_tpu_torch_extra", sys)
    assert "mofanerf_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mofanerf_tpu.ops", sys)
    assert "mofanerf_tpu" in harness.forbidden_modules()
