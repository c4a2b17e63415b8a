"""The port's spans and host-read counter (`utils/profiling.py`): off, a span
is one shared null context and records nothing; under a `torch.profiler`,
the train chunk records each phase of each step, a served frame one packet
span a packet and one host read (none with a fixed budget), and
`profiling.trace` writes the spans into its file. On the card: every host
synchronisation of a served frame, a path and a train chunk goes through
`profiling.host_read`, and the spans stay off the card's timeline (both tests skip
without a card)."""
import json

import numpy as np
import pytest
import torch

from mofanerf_tpu_torch.config import Config
from mofanerf_tpu_torch.data.device_data import DeviceDataset, DeviceSamplerConfig
from mofanerf_tpu_torch.models.student import StudentConfig, init_student_params
from mofanerf_tpu_torch.ops.rays import pose_spherical
from mofanerf_tpu_torch.ops.serve_kernel import render_packet_fused
from mofanerf_tpu_torch.render import serve
from mofanerf_tpu_torch.render.serve import render_frame_serve, render_path_serve
from mofanerf_tpu_torch.train import loop
from mofanerf_tpu_torch.train.state import create_train_state, make_optimizer
from mofanerf_tpu_torch.utils import profiling

PHASES = ("sample", "encode", "condition", "forward", "backward", "optimizer")
H, FOCAL, PACKET = 32, 60.0, 128
BOX = dict(near=8.0, far=26.0, aabb_min=(-2.0, -2.5, -2.0), aabb_max=(2.0, 2.5, 2.0))


@pytest.fixture(autouse=True)
def empty_tables():
    profiling.reset()
    yield
    profiling.reset()


def _K(h=H):
    return np.array([[FOCAL * h / H, 0, h / 2], [0, FOCAL * h / H, h / 2], [0, 0, 1]],
                    np.float32)


def _student(device="cpu", dtype=torch.float32, width=32, depth=2, multires=4):
    cfg = StudentConfig(depth=depth, width=width, multires=multires, compute_dtype=dtype)
    return init_student_params(torch.Generator().manual_seed(0), cfg, device=device), cfg


def _frame(params, cfg, hit_fraction=None, h=H):
    return render_frame_serve(params, cfg, None, h, h, _K(h), pose_spherical(10.0, -5.0, 16.0)[:3],
                              n_samples=8, packet_size=PACKET, hit_fraction=hit_fraction, **BOX)


def _path(params, cfg, frames=3, h=H):
    poses = np.stack([pose_spherical(a, -5.0, 16.0) for a in np.linspace(-30, 30, frames)])
    return render_path_serve(params, cfg, None, poses, h, h, _K(h), n_samples=8,
                             packet_size=PACKET, **BOX)


def _trainer(device="cpu", n_rand=16, hw=16):
    """A tiny model, its train state and a random split resident on `device`:
    what `train_chunk_device_data` takes after the state."""
    cfg = Config(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, multires=4,
                 multires_views=2, N_samples=4, N_importance=4, N_rand=n_rand, uv_size=128,
                 compute_dtype="float32")
    spec = cfg.model_spec()
    g = torch.Generator().manual_seed(3)
    n = 2
    c2w = torch.stack([torch.from_numpy(pose_spherical(a, 0.0, 16.0)) for a in (-20.0, 20.0)])
    dd = DeviceDataset(
        images=torch.randint(0, 256, (n, hw, hw, 3), generator=g, dtype=torch.uint8),
        poses=c2w.float(), shape_codes=torch.rand((n, spec.shape_dim), generator=g),
        exp_types=torch.tensor([0, 1], dtype=torch.int32),
        uv_maps=torch.rand((1, 128, 128, 3), generator=g),
        uv_index=torch.zeros(n, dtype=torch.int32),
        lm2d=torch.rand((n, 68, 2), generator=g) * hw,
        fg_pixels=torch.randint(0, hw, (n, 8, 2), generator=g, dtype=torch.int32))
    dd = DeviceDataset(*(t.to(device) for t in dd))
    scfg = DeviceSamplerConfig(n_rand=n_rand, H=hw, W=hw, precrop_iters=0, precrop_frac=0.5,
                               lm_frac=0.5, lm_frac_anneal_iters=0, bias="landmarks")
    state = create_train_state(torch.Generator().manual_seed(0), spec, device=device)
    K = torch.from_numpy(_K(hw)).to(device)

    def chunk(state, i0, n_steps):
        return loop.train_chunk_device_data(state, dd, K, i0, n_steps, scfg, spec,
                                            make_optimizer(), seed=5)
    return state, chunk


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.on()
        out = fn()
    assert not profiling.on()
    return out


def _count(name):
    return profiling.span_totals.get(name, [0, 0.0])[0]


def test_off_a_span_is_one_shared_object_and_nothing_is_recorded():
    assert not profiling.on()
    assert profiling.annotate("a") is profiling.annotate("b") is profiling.annotate("a")
    with profiling.annotate("a"):
        pass
    state, chunk = _trainer()
    chunk(state, 0, 1)
    params, cfg = _student()
    _frame(params, cfg)
    assert profiling.host_read(torch.tensor(2.5)) == 2.5
    assert profiling.span_totals == {} and profiling.counters == {}


def test_a_train_chunk_records_each_phase_of_each_step():
    state, chunk = _trainer()
    new, metrics = _profiled(lambda: chunk(state, 0, 2))
    assert int(new.step) == 2 and np.isfinite(float(metrics["loss"]))
    assert _count("mofanerf.train.chunk") == 1
    for phase in PHASES:
        assert _count(f"mofanerf.train.{phase}") == 2, phase
    chunk_s = profiling.span_totals["mofanerf.train.chunk"][1]
    phases_s = sum(profiling.span_totals[f"mofanerf.train.{p}"][1] for p in PHASES)
    assert 0 < phases_s <= chunk_s
    assert profiling.counters == {}   # nothing is read back inside a chunk


@pytest.mark.parametrize("hit_fraction,reads", [
    (None, 1),    # auto-budgeted: the hit share is read back once
    (1.0, 0),     # every ray, no read
])
def test_a_served_frame_records_its_packets_and_reads(monkeypatch, hit_fraction, reads):
    packets = []

    def packet(*args):
        packets.append(args[2].shape[0])
        return render_packet_fused(*args)

    monkeypatch.setattr(serve, "render_packet_fused", packet)
    params, cfg = _student()
    out = _profiled(lambda: _frame(params, cfg, hit_fraction))
    assert out["rgb"].shape == (H, H, 3)
    assert _count("mofanerf.serve.frame") == 1 and _count("mofanerf.sweep.rays") == 1
    assert _count("mofanerf.sweep.packet") == len(packets) >= 1
    assert (sum(packets) == H * H) == (hit_fraction == 1.0)
    assert _count("mofanerf.sweep.prepare") == 2   # the frame's set-up and the sweep's
    assert _count("mofanerf.sweep.assemble") == 1
    assert profiling.counters.get("host_reads", 0) == reads == _count("mofanerf.host_read")
    frame_s = profiling.span_totals["mofanerf.serve.frame"][1]
    parts = sum(profiling.span_totals[f"mofanerf.sweep.{k}"][1]
                for k in ("rays", "prepare", "packet", "assemble"))
    assert 0 < parts <= frame_s


def test_a_served_path_makes_its_rays_once_and_reads_once():
    params, cfg = _student()
    out = _profiled(lambda: _path(params, cfg, frames=3))
    assert out["rgb"].shape == (3, H, H, 3)
    assert _count("mofanerf.serve.path") == 1 and _count("mofanerf.sweep.rays") == 1
    assert _count("mofanerf.serve.frame") == 0
    assert profiling.counters["host_reads"] == 1   # the pooled compaction's budget
    assert _count("mofanerf.sweep.packet") >= 1


def test_host_read_is_item_and_counts_only_while_tracing():
    for t in (torch.tensor(3), torch.tensor(0.25), torch.tensor(True)):
        assert profiling.host_read(t) == t.item() and type(profiling.host_read(t)) is type(t.item())
    assert profiling.counters == {}
    reads = _profiled(lambda: [profiling.host_read(torch.tensor(1.5)) for _ in range(3)])
    assert reads == [1.5] * 3
    assert profiling.counters == {"host_reads": 3}
    profiling.reset()
    assert profiling.counters == {} and profiling.span_totals == {}


def test_trace_writes_the_spans_into_its_file(tmp_path):
    params, cfg = _student()
    with profiling.trace(str(tmp_path / "trace")) as prof:
        _frame(params, cfg)
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"mofanerf.serve.frame", "mofanerf.sweep.rays", "mofanerf.sweep.prepare",
            "mofanerf.sweep.packet", "mofanerf.sweep.assemble", "mofanerf.host_read"} <= names
    assert profiling.counters == {"host_reads": 1}


def test_the_print_rate_is_over_the_interval_since_the_last_print():
    import time

    t_last = time.perf_counter() - 2.0
    rate, now, i = loop._rate(130, 100, t_last)
    assert i == 130 and now >= t_last + 2.0
    assert 14.0 < rate <= 15.0   # 30 steps in a little over 2 s, not 130


@pytest.mark.cuda
def test_every_host_sync_of_the_served_and_trained_paths_is_a_host_read():
    """On the card, under torch.cuda.set_sync_debug_mode("error"): a served
    frame (its compaction reads the hit share through host_read), a short
    path and a 10-step train chunk, each warmed up first, raise nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    params, cfg = _student(dev, torch.bfloat16, width=128, depth=4, multires=10)
    state, chunk = _trainer(dev, n_rand=64, hw=32)
    runs = (lambda: _frame(params, cfg, h=64), lambda: _path(params, cfg, frames=3, h=32),
            lambda: chunk(state, 0, 10))
    for run in runs:
        run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for run in runs:
            run()
        mode = torch.cuda.get_sync_debug_mode()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert mode == 2   # host_read put the mode back after its read


@pytest.mark.cuda
def test_spans_stay_off_the_cards_timeline():
    """On the card, under a CUDA trace: the spans are host ranges only. A
    `record_function` range also lays a copy over its kernels on the card's
    timeline, which the benchmark's trace reading would count as busy time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    params, cfg = _student(dev, torch.bfloat16, width=128, depth=4, multires=10)
    state, chunk = _trainer(dev, n_rand=64, hw=32)
    _frame(params, cfg, h=64)
    chunk(state, 0, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _frame(params, cfg, h=64)
        chunk(state, 0, 2)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events if e.device_type() != cuda}
    card = [e.name() for e in events if e.device_type() == cuda]
    assert {"mofanerf.serve.frame", "mofanerf.sweep.packet", "mofanerf.train.chunk",
            "mofanerf.train.optimizer", "mofanerf.host_read"} <= host
    assert card and not [n for n in card if n.startswith("mofanerf.")]
