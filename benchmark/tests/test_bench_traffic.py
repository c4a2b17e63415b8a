"""The traffic generator: the same requests from the same seed, the same
sizes from every seed."""
import numpy as np
import pytest

from benchmark import harness, traffic

MIXES = ["viewer-frames", "turntable-paths", "teacher-views"]


def _mix(name):
    bench = harness.load_benchmark()
    wl = next(w for w in bench["workloads"] if w["traffic"] == name)
    return harness.cell(bench, wl["name"])["traffic"]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    t = _mix(name)
    a = traffic.requests(t, 2**31 + 5, n=16)
    b = traffic.requests(t, 2**31 + 5, n=16)
    for x, y in zip(a, b):
        assert (x["subject"], x["expression"]) == (y["subject"], y["expression"])
        np.testing.assert_array_equal(x["poses"], y["poses"])


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_same_sizes(name):
    t = _mix(name)
    a = traffic.requests(t, 3, n=16)
    b = traffic.requests(t, 2**40 + 3, n=16)
    assert {r["poses"].shape for r in a} == {r["poses"].shape for r in b} == {
        (t.get("frames_per_request", 1), 4, 4)}
    assert any(not np.array_equal(x["poses"], y["poses"]) for x, y in zip(a, b))


def test_turntable_turns_by_its_step():
    t = _mix("turntable-paths")
    (r,) = traffic.requests(t, 11, n=1)
    cams = r["poses"][:, :3, 3]
    az = np.degrees(np.arctan2(cams[:, 0], cams[:, 2]))
    step = (np.diff(az) + 180) % 360 - 180
    np.testing.assert_allclose(np.abs(step), t["azimuth_step_deg"], atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(cams, axis=-1), t["camera"]["radius"], rtol=1e-5)


def test_train_split_same_from_same_seed(tmp_path):
    from benchmark.common import rng
    from benchmark.splitwrite import write_split

    t = _mix("train-device-data")
    args = (2, 2, 2, 32, 60.0, t["camera"], 128, 50)
    a = write_split(str(tmp_path / "a"), rng(7, 10), *args)
    b = write_split(str(tmp_path / "b"), rng(7, 10), *args)
    for k in ("images", "poses", "shape_codes", "uv_maps", "landmarks", "exp_types"):
        np.testing.assert_array_equal(a[k], b[k])
    assert (tmp_path / "a" / "0" / "train_000.png").read_bytes() == (
        tmp_path / "b" / "0" / "train_000.png").read_bytes()
