"""The comparison fails what it has to: the control (the reference with
float8 products in the program's place) reads far above the program, and a
run whose timed path is broken underneath comes out not correct, once for
each fault its cell can have."""
import tempfile

import pytest
import torch

from benchmark import harness
from benchmark.reference.precision import Precision
from benchmark.tests.tiny import tiny_cell

CELLS = ["mofanerf.train", "mofanerf.frames", "student.viewer", "student.paths"]
# limits for the tiny cells (bf16 at widths 32-64): over the readings of their
# sound runs (train: loss 0.0083, change 0.0044; pixels: rms 0.0025,
# mean 0.0019, widest 0.008) and under those of the faults below
TINY_LIMIT = {"loss_gap": 0.015, "change_gap": 0.01, "change_worst_gap": 0.25,
              "rgb_max_gap": 0.03, "rgb_rms_gap": 0.005, "rgb_mean_gap": 0.004}


def _run(name, tmp_path, limits=TINY_LIMIT):
    c = tiny_cell(name)
    c["limits"] = {k: limits[k] for k in c["limits"]}
    out, checks = harness.run(c, 2**31 + 29, 0.2, False, 0.0, "cpu",
                              tempfile.mkdtemp(dir=tmp_path))
    return out


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tmp_path):
    out = _run(name, tmp_path)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_far_above_the_program(name, tmp_path):
    c = tiny_cell(name)
    drv = harness.runner_class(c["traffic"])(c["config"], c["traffic"], 2**31 + 41, "cpu",
                                             tempfile.mkdtemp(dir=tmp_path))
    harness.measure(drv, 0.2)
    sample = drv.collect()
    prog = drv.numbers(sample, "program")
    ctrl = drv.numbers(sample, Precision("fp8"))
    assert any(ctrl[k] >= 3 * prog[k] for k in prog), (prog, ctrl)


def _train_unchanged(state, *a, **k):
    return state, {"loss": torch.zeros(()), "psnr": torch.zeros(())}


def _half_batch(real):
    def sample(*a, **k):
        b = real(*a, **k)
        n = b.rays_o.shape[0] // 2
        return b._replace(rays_o=b.rays_o[:n], rays_d=b.rays_d[:n], target_rgb=b.target_rgb[:n],
                          coords=b.coords[:n])
    return sample


def _altered_field(real):
    def apply(*a, **k):
        rgb, sigma = real(*a, **k)
        return rgb + 2.0, sigma
    return apply


def _half_packets(real):
    calls = {"n": 0}

    def render(*a, **k):
        out = real(*a, **k)
        calls["n"] += 1
        if calls["n"] % 2:
            out = {key: torch.zeros_like(v) for key, v in out.items()}
        return out
    return render


def _altered_packet(real):
    def render(*a, **k):
        out = dict(real(*a, **k))
        out["rgb"] = out["rgb"].flip(0)
        return out
    return render


FAULTS = [
    ("mofanerf.train", "step returns its state unchanged", "benchmark.runners.train",
     "train_chunk_device_data", lambda real: _train_unchanged),
    ("mofanerf.train", "half of the batch left out", "mofanerf_tpu_torch.train.loop",
     "sample_batch_device", _half_batch),
    ("mofanerf.frames", "a field's answer altered where it is produced",
     "mofanerf_tpu_torch.render.renderer", "fused_field_apply", _altered_field),
    ("mofanerf.frames", "half of the packets left out", "mofanerf_tpu_torch.render.renderer",
     "render_rays", _half_packets),
    ("student.viewer", "a packet's answer altered where it is produced",
     "mofanerf_tpu_torch.render.serve", "render_packet_fused", _altered_packet),
    ("student.paths", "a packet's answer altered where it is produced",
     "mofanerf_tpu_torch.render.serve", "render_packet_fused", _altered_packet),
]


@pytest.mark.parametrize("name,fault,module,attr,make", FAULTS,
                         ids=[f"{f[0]}: {f[1]}" for f in FAULTS])
def test_broken_path_is_not_correct(name, fault, module, attr, make, tmp_path, monkeypatch):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    assert not _run(name, tmp_path)["correct"], fault
