"""The per-layer metrics that read the program's own spans and counters
(benchmark/program_spans.py): each on a hand-made window, None where there is
nothing to read (no span recorded, no frame or step, a program without the
tables), and the serving metrics read in a traced run of the tiny viewer cell
on the CPU."""
import tempfile

import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny_cell
from mofanerf_tpu_torch.utils import profiling

NEW = ("sample_ms_per_step", "optimizer_ms_per_step", "host_reads_per_frame",
       "prepare_ms_per_frame", "launch_ms_per_packet")
SPANS = {"mofanerf.train.sample": [20, 0.030], "mofanerf.train.optimizer": [20, 0.160],
         "mofanerf.sweep.rays": [4, 0.002], "mofanerf.sweep.prepare": [8, 0.006],
         "mofanerf.sweep.packet": [64, 0.016], "mofanerf.serve.frame": [4, 0.021]}
INFO = {"steps": 20, "frames": 4}
WANT = {"sample_ms_per_step": 1.5, "optimizer_ms_per_step": 8.0, "host_reads_per_frame": 1.0,
        "prepare_ms_per_frame": 2.0, "launch_ms_per_packet": 0.25}


@pytest.fixture
def tables():
    profiling.reset()
    yield profiling
    profiling.reset()


def _fill(spans=SPANS, reads=4):
    profiling.span_totals.update({k: list(v) for k, v in spans.items()})
    if reads:
        profiling.counters["host_reads"] = reads


@pytest.mark.parametrize("name", NEW)
def test_reads_a_hand_made_window(tables, name):
    _fill()
    assert harness.metric_reader(name)({"info": dict(INFO)}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_none_where_nothing_was_recorded(tables, name):
    read = harness.metric_reader(name)
    assert read({"info": dict(INFO)}) is None                    # tracing never on
    _fill(spans={"mofanerf.serve.frame": [4, 0.021]}, reads=0)
    if name == "host_reads_per_frame":
        assert read({"info": dict(INFO)}) == 0.0                # traced, and nothing read
        assert read({"info": {"steps": 20}}) is None            # a cell with no frames
    else:
        assert read({"info": dict(INFO)}) is None               # its span never ran
    _fill()
    if name != "launch_ms_per_packet":   # the one that divides by its own span's count
        assert read({"info": {}}) is None                       # no unit to divide by


@pytest.mark.parametrize("name", NEW)
def test_none_from_a_program_without_the_tables(tables, monkeypatch, name):
    _fill()
    monkeypatch.delattr(profiling, "span_totals")
    monkeypatch.delattr(profiling, "counters")
    assert harness.metric_reader(name)({"info": dict(INFO)}) is None


def test_the_traced_tiny_viewer_reads_its_spans(tables):
    out, _ = harness.run(tiny_cell("student.viewer"), 2**31 + 77, 0.2, True, 0.0, "cpu",
                         tempfile.mkdtemp())
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["host_reads_per_frame"] == 1.0
    assert m["prepare_ms_per_frame"] > 0 and m["launch_ms_per_packet"] > 0
    frame_ms = 1e3 * profiling.span_totals["mofanerf.serve.frame"][1] / out["attempted"]
    assert frame_ms <= m["host_ms_per_frame"]
