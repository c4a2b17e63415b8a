"""The harness finds a cell's configuration, traffic mix and per-layer
metrics by the names in BENCHMARK.json, and a cell added as new files and
entries (no existing file edited) runs."""
import json
import shutil
import tempfile

import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny_cell

BENCH = harness.load_benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(name):
    c = harness.cell(BENCH, name)
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["limits"]
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]))
    harness.runner_class(c["traffic"])


def test_dropped_in_cell_runs(tmp_path):
    """A new configuration, traffic mix and metric, each a new file, and new
    entries in BENCHMARK.json: the harness runs the new cell with no other
    change."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((root / "benchmark/configs/mofanerf-student.json").read_text())
    conf.update(name="student-narrow", depth=2, width=32, multires=4)
    (root / "benchmark/configs/student-narrow.json").write_text(json.dumps(conf))
    mix = tiny_cell("student.viewer")["traffic"]
    (root / "benchmark/traffic/viewer-dummy.json").write_text(json.dumps(mix))
    (root / "benchmark/cells/student-narrow.dummy.json").write_text(
        json.dumps({"limits": {"rgb_max_gap": 0.03, "rgb_rms_gap": 0.005}}))
    (root / "benchmark/metrics/requests_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['info']['requests'])\n")
    bench["configs"].append({"name": "student-narrow", "source": "a test",
                             "file": "benchmark/configs/student-narrow.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "student-narrow.dummy", "config": "student-narrow",
                               "traffic": "viewer-dummy", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("serve_frames_per_s", "serve_frame_p95_ms"):
            m["workloads"].append("student-narrow.dummy")
    bench["per_layer"].append({"name": "requests_traced", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "serving wrapper",
                               "moves": "serve_frames_per_s",
                               "workloads": ["student-narrow.dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.cell(harness.load_benchmark(root), "student-narrow.dummy", root)
    assert c["config"]["width"] == 32
    out, _ = harness.run(c, 12345, 0.3, True, 0.0, "cpu", tempfile.mkdtemp(dir=tmp_path))
    assert out["metrics"]["requests_traced"]["value"] >= 1
    assert out["correct"]
