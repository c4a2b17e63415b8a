"""The port's small modules against the JAX package's: `ops/uv_sample.py::
bilinear_sample` (values and gradients to the map and the coordinates, the
cases of tests/test_misc.py, at f32 rtol 1e-6 / atol 1e-6) and
`utils/profiling.py` (a trace file written on the CPU, the anomaly switch;
its spans and counters: tests/test_torch_tracing.py)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofanerf_tpu.ops.uv_sample import bilinear_sample as jax_bilinear
from mofanerf_tpu_torch.ops import bilinear_sample
from mofanerf_tpu_torch.utils import profiling

TOL = dict(rtol=1e-6, atol=1e-6)


def _uv(seed, shape=(8, 8, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("coords", [
    [[2.0, 3.0], [0.0, 0.0], [7.0, 7.0]],          # exact at pixels, both corners
    [[1.5, 1.0], [3.3, 4.7], [6.99, 0.01]],        # between pixels
    [[-2.0, 3.5], [9.0, 12.0], [7.5, -0.5]],       # clipped to the map
], ids=["pixels", "between", "clipped"])
def test_bilinear_sample_values_match_jax(coords):
    uv = _uv(0)
    c = np.asarray(coords, np.float32)
    got = bilinear_sample(torch.from_numpy(uv), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_bilinear(jnp.asarray(uv),
                                                                    jnp.asarray(c))), **TOL)
    if coords[0] == [2.0, 3.0]:
        np.testing.assert_allclose(got[0].numpy(), uv[2, 3], atol=1e-6)
        np.testing.assert_allclose(got[2].numpy(), uv[7, 7], atol=1e-6)


def test_bilinear_sample_interpolates():
    uv = torch.zeros(4, 4, 1)
    uv[1, 1, 0] = 1.0
    assert abs(float(bilinear_sample(uv, torch.tensor([[1.5, 1.0]]))[0, 0]) - 0.5) < 1e-6


def test_bilinear_sample_gradients_match_jax():
    uv = _uv(1)
    c = np.asarray([[3.3, 4.7], [0.2, 6.1], [5.5, 5.5]], np.float32)
    w = np.random.default_rng(2).standard_normal((3, 3)).astype(np.float32)

    def jloss(m, cc):
        return jnp.sum(jax_bilinear(m, cc) * w)

    jg_map, jg_c = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(uv), jnp.asarray(c))
    tm = torch.from_numpy(uv).requires_grad_(True)
    tc = torch.from_numpy(c).requires_grad_(True)
    (bilinear_sample(tm, tc) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jg_map), **TOL)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jg_c), rtol=1e-5, atol=1e-5)
    assert np.abs(tc.grad.numpy()).sum() > 0


def test_trace_writes_a_file_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("matmul block"):
            (x @ x).sum()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "matmul block" in names and any("mm" in str(n) for n in names)


def test_nan_checks_switch_anomaly_mode():
    try:
        profiling.enable_nan_checks()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).sum().backward()
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
