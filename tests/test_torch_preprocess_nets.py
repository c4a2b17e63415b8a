"""The port's preprocessing networks (preprocess/segment.py's BiSeNet,
preprocess/relight.py's HourglassNet) against the JAX package's flax modules.

Weights come from one random state dict in the reference's key layout
(`make_bisenet_sd` / `make_hourglass_sd` of tests/test_preprocess_oracle.py,
BatchNorm running statistics included) and reach each side three ways: the
JAX converter to flax variables; the port's converter straight to its
parameters; and the JAX converter's variables through
`bridge.bisenet_params_to_torch` / `hourglass_params_to_torch`. Tolerance: the
logits and the relit L at relative 1e-4 of the output's largest magnitude;
parse maps equal wherever JAX's top-2 logit margin exceeds that tolerance
(argmax of random weights flips on near-ties).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_preprocess_oracle import make_bisenet_sd, make_hourglass_sd

from mofanerf_tpu.preprocess import relight as jrel
from mofanerf_tpu.preprocess import segment as jseg
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.preprocess import relight as trel
from mofanerf_tpu_torch.preprocess import segment as tseg

RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the suite runs
    several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bisenet():
    sd = make_bisenet_sd(torch.Generator().manual_seed(11))
    jv = jseg.convert_bisenet_weights(sd)
    states = {"converter": tseg.convert_bisenet_weights(sd, "cpu"),
              "bridge": bridge.bisenet_params_to_torch(jax.tree.map(np.asarray, jv), "cpu")}
    return jv, states


@pytest.fixture(scope="module")
def hourglass():
    sd = make_hourglass_sd(torch.Generator().manual_seed(3))
    jv = jrel.convert_hourglass_weights(sd)
    states = {"converter": trel.convert_hourglass_weights(sd, "cpu"),
              "bridge": bridge.hourglass_params_to_torch(jax.tree.map(np.asarray, jv), "cpu")}
    return sd, jv, states


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("route", ["converter", "bridge"])
@pytest.mark.parametrize("hw", [(64, 64), (72, 88)], ids=["64x64", "72x88"])
def test_bisenet_logits_match_jax(bisenet, route, hw):
    """72 x 88 is not a power of two: the context path's nearest upsamplings
    (3 -> 5 x 6 -> 9 x 11) hit half-pixel positions that fall on integers,
    where torch's `nearest` and JAX's half-pixel rule part."""
    jv, states = bisenet
    x = np.random.default_rng(0).normal(size=(1,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jseg.BiSeNet().apply(jv, jnp.asarray(x)))[0].transpose(2, 0, 1)
    net = tseg.load_bisenet(states[route])
    got = net(torch.from_numpy(x.transpose(0, 3, 1, 2)))[0].numpy()
    _close(got, want)


def test_resize_nearest_is_jax_half_pixel_rule():
    x = torch.arange(6 * 7, dtype=torch.float32).reshape(1, 1, 6, 7)
    for hw in ((11, 13), (9, 5), (12, 14), (3, 2)):
        want = np.asarray(jax.image.resize(jnp.asarray(x.numpy()), (1, 1) + hw, "nearest"))
        np.testing.assert_array_equal(tseg.resize_nearest(x, hw).numpy(), want)


def test_segment_face_parse_map_matches_jax_where_decided(bisenet):
    jv, states = bisenet
    img = np.random.default_rng(1).uniform(0, 1, (72, 88, 3)).astype(np.float32)
    want = jseg.segment_face(img, jv)
    got = tseg.segment_face(img, states["converter"])
    assert got.shape == (72, 88) and got.max() < tseg.N_CLASSES
    x = (img - jseg._MEAN) / jseg._STD
    logits = np.sort(np.asarray(jseg.BiSeNet().apply(jv, jnp.asarray(x[None])))[0], -1)
    decided = logits[..., -1] - logits[..., -2] > RTOL * np.abs(logits).max()
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got[decided], want[decided])
    # a module and its state dict give the same map
    np.testing.assert_array_equal(tseg.segment_face(img, tseg.load_bisenet(states["bridge"])),
                                  got)


@pytest.mark.parametrize("route", ["converter", "bridge"])
@pytest.mark.parametrize("skip_count", [0, 2])
def test_hourglass_matches_jax(hourglass, route, skip_count):
    _, jv, states = hourglass
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(1, 64, 64, 1)).astype(np.float32)
    tl = rng.normal(size=(1, 1, 1, 9)).astype(np.float32)
    want_l, want_sh = jrel.HourglassNet().apply(jv, jnp.asarray(x), jnp.asarray(tl),
                                                skip_count=skip_count)
    net = trel.load_hourglass(states[route], skip_count=skip_count)
    got_l, got_sh = net(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                        torch.from_numpy(tl.reshape(1, 9, 1, 1)))
    _close(got_l[0, 0].numpy(), np.asarray(want_l)[0, ..., 0])
    _close(got_sh.reshape(9).numpy(), np.asarray(want_sh).reshape(9))


def test_hourglass_matches_the_reference_forward(hourglass):
    """The port's converter against the independent torch functional forward
    of the reference (tests/test_preprocess_oracle.py), with its BatchNorms
    unfolded."""
    from test_preprocess_oracle import torch_hourglass_forward

    sd, _, states = hourglass
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(size=(1, 1, 64, 64)).astype(np.float32))
    tl = torch.from_numpy(rng.normal(size=(1, 9, 1, 1)).astype(np.float32))
    want, want_sh = torch_hourglass_forward(sd, x, tl)
    got, got_sh = trel.load_hourglass(states["converter"])(x, tl)
    _close(got.numpy(), want.numpy())
    _close(got_sh.numpy(), want_sh.numpy())


@pytest.mark.parametrize("hw", [(64, 64), (48, 40)], ids=["at_size", "resized"])
def test_relight_to_canonical_matches_jax(hourglass, hw):
    """The whole relight: 8-bit Lab in, the net on L, the relit L truncated
    to bytes and Lab back to RGB (and, off size, INTER_LINEAR both ways).
    The relit L of the two nets differs by ~1e-7 and its truncation to bytes
    can flip by one, which Lab -> RGB spreads to a few levels of RGB: held at
    4 levels at most and a mean under 0.1 level."""
    _, jv, states = hourglass
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, hw + (3,)).astype(np.float32)
    sh = rng.normal(size=9)
    want, want_sh = jrel.relight_to_canonical(img, jv, sh, size=64)
    got, got_sh = trel.relight_to_canonical(img, states["converter"], sh, size=64)
    assert got.shape == hw + (3,)
    diff = np.abs(got.numpy() - want) * 255
    assert diff.max() <= 4 + 1e-3 and diff.mean() < 0.1, (diff.max(), diff.mean())
    _close(got_sh, np.asarray(want_sh))


def test_converters_check_the_layout():
    sd = make_hourglass_sd(torch.Generator().manual_seed(5))
    del sd["output.bias"]
    with pytest.raises(KeyError):
        trel.convert_hourglass_weights(sd, "cpu")
    jv = jax.tree.map(np.asarray, jseg.convert_bisenet_weights(
        make_bisenet_sd(torch.Generator().manual_seed(6))))
    del jv["params"]["ffm"]["conv2"]
    with pytest.raises(ValueError, match="BiSeNet parameters do not match"):
        bridge.bisenet_params_to_torch(jv, "cpu")


def test_networks_run_with_tf32_off(bisenet, hourglass, monkeypatch):
    """segment_logits and relight_to_canonical run their net with TF32 off in
    cuBLAS and cuDNN (the card's default lets cuDNN convolutions use TF32),
    whatever the caller's settings, and restore them after."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    record = lambda module, args: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    seg = tseg.load_bisenet(bisenet[1]["converter"])
    hg = trel.load_hourglass(hourglass[2]["converter"])
    seg.register_forward_pre_hook(record)
    hg.register_forward_pre_hook(record)
    img = np.random.default_rng(5).uniform(0, 1, (32, 32, 3)).astype(np.float32)
    tseg.segment_logits(torch.from_numpy(img), seg)
    trel.relight_to_canonical(img, hg, np.ones(9), size=32)
    assert seen == [(False, False), (False, False)]
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
