"""Write the Orbax steps of mofanerf_tpu_torch/testdata/orbax/ and their
manifest.json (a script run by hand, not a test; the CPU, no card):

    JAX_PLATFORMS=cpu python tests/torch_orbax_fixtures.py mofanerf_tpu_torch/testdata/orbax

Each step lies in a checkpoint directory of its own, `<name>/<step:06d>/`:

- `small_{ocdbt,files}_{zarr2,zarr3}`: `test_torch_orbax_variants.variant_tree`
  (f32 with edge chunks, bf16, int32, a scalar, zeros, an f32 array over 8
  virtual CPU devices) saved by orbax's PyTreeCheckpointHandler in each of
  the four layouts, several chunks an array, with the array `w` rewritten by
  tensorstore (zarr v2 big-endian in Fortran order; zarr v3 shards of
  several big-endian inner chunks under a transpose);
- `numbered_zarr3`: the zarr v3 + OCDBT step with its database rewritten as
  numbered manifests (three versions);
- `missing_zarr3`: a zarr v3 step without OCDBT whose `w` leaves its
  all-zero inner chunks unstored (Orbax's restore refuses it; the port reads
  the fill value, as tensorstore does);
- `model_zarr3`: the params of the JAX package's `init_model_params` (seed
  0) at the narrow spec of `FLAGS`, as `{"params": ...}` through the zarr v3
  + OCDBT handler, its leaves rounded to bf16-representable f32 values so
  that zstd halves them (the step stays small; the render route reads them
  as any f32 weights).

The manifest gives each step's leaves by key path, with shape, dtype and
SHA-256 (`test_torch_orbax_variants.leaf_digest`, chip_smoke.py's
`_digest`), and whether Orbax's restore reads the step. Deterministic but
for OCDBT's random file names and uuids."""
import json
import os
import shutil
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402

from mofanerf_tpu.config import Config  # noqa: E402
from mofanerf_tpu.render.renderer import init_model_params  # noqa: E402
from mofanerf_tpu_torch.train.orbax import read_step  # noqa: E402
from mofanerf_tpu_torch.utils.tree import flatten_with_keystr  # noqa: E402
from tests.test_torch_orbax_variants import (LAYOUTS, leaf_digest, numbered_copy,  # noqa: E402
                                             rewrite_array, variant_tree, write_variant)

FLAGS = {"netdepth": 6, "netwidth": 64, "netdepth_fine": 6, "netwidth_fine": 64,
         "multires": 4, "multires_views": 2, "uv_size": 128}


def make(out_dir):
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    steps = {}
    for i, (layout, (use_ocdbt, use_zarr3)) in enumerate(LAYOUTS.items()):
        path = os.path.join(out_dir, f"small_{layout}", "000001")
        write_variant(path, variant_tree(i), use_ocdbt, use_zarr3)
        w = np.random.default_rng(100 + i).standard_normal((37, 29)).astype(np.float32)
        rewrite_array(path, "w", w, use_ocdbt, use_zarr3)
        steps[f"small_{layout}"] = ("000001", True, {})
    tmp = os.path.join(out_dir, "_src")
    write_variant(tmp, variant_tree(7), True, True)
    numbered_copy(tmp, os.path.join(out_dir, "numbered_zarr3", "000002"), batches=3)
    shutil.rmtree(tmp)
    steps["numbered_zarr3"] = ("000002", True, {})
    path = os.path.join(out_dir, "missing_zarr3", "000003")
    write_variant(path, variant_tree(8, sharded=False), False, True)
    w = np.random.default_rng(108).standard_normal((37, 29)).astype(np.float32)
    w[8:20] = 0.0
    rewrite_array(path, "w", w, False, True, store_fill=False)
    steps["missing_zarr3"] = ("000003", False, {})
    spec = Config(**FLAGS).model_spec()
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16).astype(x.dtype)
                          if x.dtype == jnp.float32 else x,
                          init_model_params(jax.random.PRNGKey(0), spec))
    handler = ocp.PyTreeCheckpointHandler(use_ocdbt=True, use_zarr3=True)
    ocp.Checkpointer(handler).save(os.path.abspath(os.path.join(out_dir, "model_zarr3", "000007")),
                                   args=ocp.args.PyTreeSave({"params": params}), force=True)
    steps["model_zarr3"] = ("000007", True, FLAGS)
    manifest = {"steps": {}}
    for name, (step, orbax_reads, flags) in sorted(steps.items()):
        tree = read_step(os.path.join(out_dir, name, step))
        leaves = {k: {"shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", ""),
                      "sha256": leaf_digest(t)} for k, t in flatten_with_keystr(tree)}
        manifest["steps"][name] = {"step": step, "orbax_reads": orbax_reads, "leaves": leaves}
        if flags:
            manifest["steps"][name]["flags"] = flags
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(out_dir) for f in fs)
    print(f"{out_dir}: {len(steps)} steps, {size} bytes")
    return manifest


if __name__ == "__main__":
    make(sys.argv[1])
