"""prepare_kernel_share (benchmark/metrics/prepare_kernel_share.py): 100 x the
program's counter `serve_rays_frames` over the window's frames, on hand-made
counters; None where tracing recorded nothing, the counter never counted or the
program has no such table; and left out of the traced tiny serving cells' lines
on the CPU, where no kernel launches."""
import tempfile

import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny_cell
from mofanerf_tpu_torch.utils import profiling

INFO = {"steps": 20, "frames": 4}


@pytest.fixture
def tables():
    profiling.reset()
    yield profiling
    profiling.reset()


def _traced():
    """A traced window's tables: a few spans and the frame's one host read."""
    profiling.span_totals.update({"mofanerf.sweep.rays": [4, 0.002],
                                  "mofanerf.serve.frame": [4, 0.021]})
    profiling.counters["host_reads"] = 4


@pytest.mark.parametrize("made,frames,want", [(4, 4, 100.0), (60, 60, 100.0), (3, 4, 75.0)])
def test_prepare_kernel_share_reads_the_counter_over_the_frames(tables, made, frames, want):
    _traced()
    profiling.counters["serve_rays_frames"] = made
    read = harness.metric_reader("prepare_kernel_share")
    assert read({"info": {"frames": frames}}) == pytest.approx(want)
    assert read({"info": {}}) is None                           # no frames to divide by


def test_prepare_kernel_share_is_none_where_nothing_was_counted(tables, monkeypatch):
    read = harness.metric_reader("prepare_kernel_share")
    assert read({"info": dict(INFO)}) is None                    # tracing never on
    _traced()
    assert read({"info": dict(INFO)}) is None                    # traced, never counted
    profiling.counters["serve_rays_frames"] = 4
    monkeypatch.delattr(profiling, "counters")
    assert read({"info": dict(INFO)}) is None                    # a program without the tables


def test_the_traced_tiny_cells_make_every_frames_rays_in_one_call(tables):
    """On the CPU the frames' rays come from serve_rays' plain version, which
    launches no kernel: the counter stays empty and the line leaves the share
    out (on the card each frame's launch counts, tests/test_torch_serve_kernel.py)."""
    for name in ("student.viewer", "student.paths"):
        profiling.reset()
        out, _ = harness.run(tiny_cell(name), 2**31 + 78, 0.2, True, 0.0, "cpu",
                             tempfile.mkdtemp())
        assert "prepare_kernel_share" not in out["metrics"], name
        assert "serve_rays_frames" not in profiling.counters, name
        assert out["metrics"]["prepare_ms_per_frame"]["value"] > 0, name   # traced all the same
