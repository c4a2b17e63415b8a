"""The port's Config against the JAX package's: the same fields and defaults,
the shipped config file parsed to the same values, CLI overrides with the
same precedence, and the same model dimensions out of `model_spec()`."""
import dataclasses
import os

import jax.numpy as jnp
import pytest
import torch

from mofanerf_tpu import config as jconfig
from mofanerf_tpu_torch import config as tconfig

CONFIG_FILE = os.path.join(os.path.dirname(__file__), "..", "configs", "exp_mofanerf.txt")
DTYPE_NAMES = {jnp.float32: "float32", jnp.bfloat16: "bfloat16",
               torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _spec_dims(spec):
    """A model spec as plain values, dtypes by name."""
    d = dataclasses.asdict(spec)
    for f in ("coarse", "fine"):
        d[f]["compute_dtype"] = DTYPE_NAMES[d[f]["compute_dtype"]]
    return d


def test_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.Config)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.Config)}
    assert jf == tf
    assert _spec_dims(tconfig.Config().model_spec()) == _spec_dims(jconfig.Config().model_spec())


@pytest.mark.parametrize("argv", [
    ["--config", CONFIG_FILE],
    ["--config", CONFIG_FILE, "--netwidth_fine", "128", "--compute_dtype", "float32",
     "--white_bkgd", "true", "--N_importance", "0", "--near", "7.5"],
    ["--netdepth", "6", "--lindisp", "yes", "--sigma_activation", "softplus", "--unknown", "x"],
])
def test_load_config_matches_jax(argv):
    jc, tc = jconfig.load_config(argv), tconfig.load_config(argv)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jdims, tdims = _spec_dims(jc.model_spec()), _spec_dims(tc.model_spec())
    assert tdims == jdims
    spec = tc.model_spec()
    assert isinstance(spec.fine.compute_dtype, torch.dtype)
    assert (spec.coarse.pts_embed_dim, spec.coarse.views_embed_dim) == (63, 27)


def test_shipped_config_file_values():
    assert tconfig.parse_config_file(CONFIG_FILE) == jconfig.parse_config_file(CONFIG_FILE)
    cfg = tconfig.load_config(["--config", CONFIG_FILE])
    spec = cfg.model_spec()
    assert (spec.coarse.depth, spec.coarse.width) == (8, 256)
    assert (spec.fine.depth, spec.fine.width) == (10, 1024)
    assert (spec.render.n_coarse, spec.render.n_importance) == (64, 64)
    assert spec.fine.compute_dtype == torch.bfloat16 and spec.render.packet_size == 8192
