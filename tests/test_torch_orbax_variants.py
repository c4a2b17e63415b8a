"""Every Orbax step layout that `StandardCheckpointer().restore` reads, read
by the port (mofanerf_tpu_torch/train/orbax.py over utils/ocdbt.py) with
jax, orbax, tensorstore, zstandard and mofanerf_tpu blocked.

orbax-checkpoint's `PyTreeCheckpointHandler` writes a tree of f32, bf16 and
int32 leaves (edge chunks, a scalar, zeros, an array sharded over the 8
virtual CPU devices, several chunks an array by a small `chunk_byte_size`)
in the four layouts `use_ocdbt` x `use_zarr3`; one array is then rewritten
by tensorstore with what zarr allows and Orbax does not write (zarr v2:
big-endian, Fortran order; zarr v3: a `transpose` codec, a shard of several
inner chunks, big-endian inner chunks, the "v2" chunk key encoding). Each
step is held bit for bit against `StandardCheckpointer().restore`. Also: an
OCDBT database of numbered manifests (tensorstore's
`manifest_kind: numbered`, more versions than its manifests keep inline)
against tensorstore and Orbax; chunks and inner chunks not stored (the
fill value, as tensorstore reads them; Orbax's restore refuses such a step,
having asked for every chunk); a narrow TrainState in the zarr v3 + OCDBT
layout through `restore_checkpoint` against `bridge.train_state_to_torch`;
the committed steps of mofanerf_tpu_torch/testdata/orbax/ against their
manifest and Orbax; run_render from the committed model step on the CPU;
and damaged steps, which raise ValueError.

The writers (`variant_tree`, `write_variant`, `rewrite_array`,
`numbered_copy`) also make the committed steps:

    JAX_PLATFORMS=cpu python tests/torch_orbax_fixtures.py mofanerf_tpu_torch/testdata/orbax
"""
import hashlib
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from mofanerf_tpu.train import state as jstate
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.train import checkpoint as ck
from mofanerf_tpu_torch.train import state as tstate
from mofanerf_tpu_torch.train.orbax import read_step
from mofanerf_tpu_torch.utils import ocdbt
from mofanerf_tpu_torch.utils.tree import flatten_with_keystr
from tests.test_torch_orbax import _assert_trees_equal, _np, blocked
from tests.test_torch_train_state import _specs

ORBAX_FIXTURES = os.path.join(os.path.dirname(ck.__file__), "..", "testdata", "orbax")
LAYOUTS = {"ocdbt_zarr2": (True, False), "ocdbt_zarr3": (True, True),
           "files_zarr2": (False, False), "files_zarr3": (False, True)}


def variant_tree(seed=0, sharded=True):
    """f32 with edge chunks, bf16, int32, a scalar, zeros, nested keys, and
    (`sharded`) an f32 array over the 8 virtual CPU devices (4 x 2 mesh)."""
    rng = np.random.default_rng(seed)
    tree = {"w": jnp.asarray(rng.standard_normal((37, 29)), jnp.float32),
            "bf": jnp.asarray(rng.standard_normal((13, 7)), jnp.bfloat16),
            "i": jnp.asarray(rng.integers(-1000, 1000, (5,)), jnp.int32),
            "scalar": jnp.int32(int(rng.integers(1, 99))),
            "nest": {"z": jnp.zeros((4, 3), jnp.float32),
                     "v": jnp.asarray(rng.standard_normal((10,)), jnp.float32)}}
    if sharded:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("a", "b"))
        tree["s"] = jax.device_put(jnp.asarray(rng.standard_normal((4 * 6, 2 * 5)), jnp.float32),
                                   NamedSharding(mesh, P("a", "b")))
    return tree


def write_variant(path, tree, use_ocdbt, use_zarr3, chunk_byte_size=256):
    """`tree` saved by orbax's PyTreeCheckpointHandler at `path`; a small
    `chunk_byte_size` gives each array several chunks."""
    save_args = jax.tree.map(lambda _: ocp.SaveArgs(chunk_byte_size=chunk_byte_size), tree)
    handler = ocp.PyTreeCheckpointHandler(use_ocdbt=use_ocdbt, use_zarr3=use_zarr3)
    ocp.Checkpointer(handler).save(os.path.abspath(path),
                                   args=ocp.args.PyTreeSave(tree, save_args=save_args),
                                   force=True)


def _kvstore(path, use_ocdbt, key):
    path = os.path.abspath(path)
    if use_ocdbt:
        return {"driver": "ocdbt", "base": f"file://{path}/", "path": f"{key}/"}
    return {"driver": "file", "path": f"{path}/{key}/"}


def array_spec(path, key, shape, use_ocdbt, use_zarr3, store_fill=True):
    """A tensorstore spec of array `key` of the step at `path` (f32 of
    `shape`): zarr v2 big-endian in Fortran order, chunks 8 x 16; zarr v3
    shards of 16 x 16 under a transpose, each of 4 x 8 big-endian inner
    chunks, chunk keys in the "v2" encoding."""
    if use_zarr3:
        meta = {"shape": list(shape), "data_type": "float32", "fill_value": 0.0,
                "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": [16, 16]}},
                "chunk_key_encoding": {"name": "v2"},
                "codecs": [{"name": "transpose", "configuration": {"order": [1, 0]}},
                           {"name": "sharding_indexed", "configuration": {
                               "chunk_shape": [4, 8],
                               "codecs": [{"name": "bytes", "configuration": {"endian": "big"}},
                                          {"name": "zstd"}],
                               "index_codecs": [{"name": "bytes",
                                                 "configuration": {"endian": "little"}},
                                                {"name": "crc32c"}]}}]}
        driver = "zarr3"
    else:
        meta = {"shape": list(shape), "chunks": [8, 16], "dtype": ">f4", "order": "F",
                "compressor": {"id": "zstd", "level": 3}, "fill_value": 0}
        driver = "zarr"
    return {"driver": driver, "kvstore": _kvstore(path, use_ocdbt, key), "metadata": meta,
            "store_data_equal_to_fill_value": store_fill}


def rewrite_array(path, key, a, use_ocdbt, use_zarr3, store_fill=True):
    """Array `key` of the step at `path` written anew by tensorstore as
    `array_spec` says; `store_fill=False` leaves chunks (and inner chunks)
    that hold only the fill value unstored."""
    import tensorstore as ts

    spec = array_spec(path, key, a.shape, use_ocdbt, use_zarr3, store_fill)
    ts.open(spec, create=True, delete_existing=True).result()[...] = a


def numbered_copy(src, dst, batches):
    """The OCDBT step `src` copied to `dst` with its database rewritten as
    numbered manifests, its keys written in `batches` transactions (one
    numbered manifest each)."""
    import tensorstore as ts

    os.makedirs(dst)
    for name in os.listdir(src):
        if name.startswith("_"):
            shutil.copy(os.path.join(src, name), dst)
    old = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(src)}/"}).result()
    new = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(dst)}/",
                           "config": {"manifest_kind": "numbered"}}).result()
    keys = old.list().result()
    for part in np.array_split(np.arange(len(keys)), batches):
        txn = ts.Transaction()
        for i in part:
            new.with_transaction(txn)[keys[i]] = old.read(keys[i]).result().value
        txn.commit_async().result()


def leaf_digest(t):
    """SHA-256 of a tensor's bytes in C order (bf16 by its bits), as
    chip_smoke.py's `_digest` hashes."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def _restored(path):
    """StandardCheckpointer().restore of the step at `path`, as numpy leaves
    (bf16 as its bits)."""
    tree = ocp.StandardCheckpointer().restore(os.path.abspath(path))
    return jax.tree.map(lambda x: np.asarray(x).view(np.int16) if x.dtype == jnp.bfloat16
                        else np.asarray(x), tree)


def assert_same_as(got, want, prefix=""):
    """A port tree against a numpy tree, leaf by leaf, bit for bit."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), prefix
        for k in want:
            assert_same_as(got[k], want[k], f"{prefix}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), prefix
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_as(g, w, f"{prefix}/{i}")
        return
    g = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
    g = g.numpy()
    assert g.shape == want.shape and g.dtype == want.dtype, (prefix, g.shape, want.shape)
    assert np.array_equal(g, want), prefix


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_matches_standard_checkpointer(tmp_path, layout):
    """The four layouts Orbax writes, with one array rewritten by tensorstore
    (every chunk stored), bit for bit against Orbax's own restore; the step
    found by latest_step."""
    use_ocdbt, use_zarr3 = LAYOUTS[layout]
    step = tmp_path / "ckpt" / "000005"
    write_variant(step, variant_tree(), use_ocdbt, use_zarr3)
    a = np.random.default_rng(9).standard_normal((37, 29)).astype(np.float32)
    rewrite_array(step, "w", a, use_ocdbt, use_zarr3)
    want = _restored(step)
    assert np.array_equal(want["w"], a)
    with blocked():
        got = read_step(str(step))
        assert ck.latest_step(str(tmp_path / "ckpt")) == 5
    assert_same_as(got, want)
    names = set(os.listdir(step))
    assert ("manifest.ocdbt" in names) == use_ocdbt
    meta = "zarr.json" if use_zarr3 else ".zarray"
    if not use_ocdbt:
        assert os.path.isfile(step / "i" / meta)


def test_numbered_manifest_matches_tensorstore_and_orbax(tmp_path):
    """A zarr v3 + OCDBT step whose database is rewritten as numbered
    manifests over 20 versions (more than the 16 a manifest keeps inline:
    tensorstore moves the older ones to version tree nodes): the keys and
    values against tensorstore's, the tree against Orbax's restore."""
    import tensorstore as ts

    src, dst = tmp_path / "src", tmp_path / "000003"
    write_variant(src, variant_tree(1), True, True)
    numbered_copy(src, dst, batches=20)
    names = sorted(os.listdir(dst))
    assert sum(n.startswith("manifest.0") for n in names) >= 20
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{dst}/"}).result()
    want_kv = {k: kv.read(k).result().value for k in kv.list().result()}
    want = _restored(dst)
    with blocked():
        db = ocdbt.Database(str(dst))
        got_kv = {k: db.value(ref) for k, ref in db.entries().items()}
        got = read_step(str(dst))
    assert got_kv == want_kv
    assert_same_as(got, want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_chunks_not_stored_hold_the_fill_value(tmp_path, layout):
    """An array rewritten with its all-fill chunks (zarr v3: inner chunks,
    index entries of 2^64 - 1) left unstored reads as tensorstore reads it.
    Orbax's restore refuses such a step: it asks tensorstore for every
    chunk, having written every one."""
    import tensorstore as ts

    use_ocdbt, use_zarr3 = LAYOUTS[layout]
    step = tmp_path / "000002"
    write_variant(step, variant_tree(2, sharded=False), use_ocdbt, use_zarr3)
    a = np.random.default_rng(3).standard_normal((37, 29)).astype(np.float32)
    a[8:20] = 0.0
    a[:, 24:] = 0.0
    rewrite_array(step, "w", a, use_ocdbt, use_zarr3, store_fill=False)
    want = ts.open(array_spec(step, "w", a.shape, use_ocdbt, use_zarr3)).result().read().result()
    assert np.array_equal(want, a)
    with pytest.raises(Exception, match="missing"):
        ocp.StandardCheckpointer().restore(str(step))
    with blocked():
        got = read_step(str(step))
    assert torch.equal(got["w"], torch.from_numpy(a))


@pytest.mark.parametrize("codec", ["v2 zlib", "v2 gzip", "v2 bz2", "v2 none", "v3 gzip",
                                   "v3 crc32c", "v3 unsharded", "v2 nan", "v3 nan"])
def test_other_codecs_read_as_tensorstore_reads(tmp_path, codec):
    """What tensorstore's zarr drivers read and Orbax does not write: zarr v2
    with the zlib, gzip, bz2 or no compressor; zarr v3 chunks coded by
    gzip, checked by crc32c, or not sharded at all; a fill value of NaN
    (written "NaN") in the chunks left unstored."""
    import tensorstore as ts

    version, name = codec.split()
    step = tmp_path / "000001"
    write_variant(step, variant_tree(5, sharded=False), False, version == "v3")
    a = np.random.default_rng(6).standard_normal((37, 29)).astype(np.float32)
    spec = array_spec(step, "w", a.shape, False, version == "v3")
    if name == "nan":
        a[:16] = np.nan
        spec["metadata"]["fill_value"] = "NaN"
        spec["store_data_equal_to_fill_value"] = False
    elif version == "v2":
        spec["metadata"]["compressor"] = None if name == "none" else {"id": name}
    else:
        inner = [{"name": "bytes", "configuration": {"endian": "little"}},
                 {"name": "gzip"} if name == "gzip" else {"name": "crc32c"}]
        spec["metadata"]["codecs"] = inner if name == "unsharded" else [
            {"name": "sharding_indexed", "configuration": {"chunk_shape": [4, 8],
                                                           "codecs": inner}}]
    ts.open(spec, create=True, delete_existing=True).result()[...] = a
    with blocked():
        got = read_step(str(step))
    assert np.array_equal(got["w"].numpy(), a, equal_nan=True)
    meta = json.loads((step / "w" / ("zarr.json" if version == "v3" else ".zarray")).read_text())
    assert name != "nan" or meta["fill_value"] == "NaN"


def test_train_state_in_zarr3_ocdbt_restores(tmp_path):
    """A narrow JAX TrainState (its structure from create_train_state, its
    leaves a seeded numpy draw: params, Adam moments not zero, counts and
    step 3) saved with the zarr v3 + OCDBT handler at <ckpt>/000003, as the
    JAX package's save_checkpoint lays it out: restore_checkpoint and
    load_model against bridge.train_state_to_torch."""
    jspec, tspec = _specs()
    shapes = jax.eval_shape(lambda k: jstate.create_train_state(k, jspec), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    state = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(s.dtype)
                         if s.dtype.kind == "f" else np.full(s.shape, 3, s.dtype), shapes)
    handler = ocp.PyTreeCheckpointHandler(use_ocdbt=True, use_zarr3=True)
    ocp.Checkpointer(handler).save(str(tmp_path / "000003"), args=ocp.args.PyTreeSave(state))
    target = tstate.create_train_state(torch.Generator().manual_seed(3), tspec, device="cpu")
    with blocked():
        got = ck.restore_checkpoint(str(tmp_path), target, spec=tspec)
        params, step = ck.load_model(str(tmp_path), tspec, "cpu")
    want = bridge.train_state_to_torch(_np(state), tspec, "cpu")
    _assert_trees_equal(ck._as_tree(got), ck._as_tree(want))
    _assert_trees_equal(params, want.params)
    assert step == 3 and int(got.opt_state.count) == 3


def test_refine_state_without_ocdbt_restores(tmp_path):
    """A RefineState (the refiner's generator, discriminators and both Adam
    states; a seeded numpy draw on create's structure) saved with the zarr v3
    handler without OCDBT: restore_checkpoint, which run_refine's and
    run_train_refinenet's resumes call, against bridge.refine_state_to_torch."""
    from mofanerf_tpu.train import refine as jref
    from mofanerf_tpu_torch.train import refine as tref

    small = dict(ngf=4, ndf=4, n_downsampling=1, n_blocks=1, num_D=2, n_layers_D=1)
    jcfg, tcfg = jref.RefineConfig(**small), tref.RefineConfig(**small)
    shapes = jax.eval_shape(lambda k: jref.init_refine_state(k, jcfg, image_size=16),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    state = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(s.dtype)
                         if s.dtype.kind == "f" else np.full(s.shape, 3, s.dtype), shapes)
    handler = ocp.PyTreeCheckpointHandler(use_ocdbt=False, use_zarr3=True)
    ocp.Checkpointer(handler).save(str(tmp_path / "000003"), args=ocp.args.PyTreeSave(state))
    target = tref.init_refine_state(torch.Generator().manual_seed(1), tcfg, device="cpu")
    with blocked():
        got = ck.restore_checkpoint(str(tmp_path), target, spec=tcfg)
    want = bridge.refine_state_to_torch(_np(state), tcfg, "cpu")
    _assert_trees_equal(tref.refine_tree(got), tref.refine_tree(want))
    assert int(got.g_opt.count) == 3


def _manifest():
    with open(os.path.join(ORBAX_FIXTURES, "manifest.json")) as f:
        return json.load(f)


def test_committed_steps_match_their_manifest_and_orbax():
    """Every committed step: each leaf's shape, dtype and SHA-256 as the
    manifest says, read with the JAX side blocked; and the same leaves from
    Orbax's restore, where Orbax reads the step."""
    manifest = _manifest()
    assert sorted(manifest["steps"]) == sorted(
        d for d in os.listdir(ORBAX_FIXTURES) if d != "manifest.json")
    for name, entry in manifest["steps"].items():
        path = os.path.join(ORBAX_FIXTURES, name, entry["step"])
        with blocked():
            got = dict(flatten_with_keystr(read_step(path)))
        assert sorted(got) == sorted(entry["leaves"]), name
        for k, leaf in entry["leaves"].items():
            t = got[k]
            assert [list(t.shape), str(t.dtype).replace("torch.", ""), leaf_digest(t)] == \
                [leaf["shape"], leaf["dtype"], leaf["sha256"]], (name, k)
        if entry["orbax_reads"]:
            assert_same_as(read_step(path), _restored(path))


def test_run_render_from_the_committed_model_step(tmp_path):
    """run_render --ckpt_dir on a copy of the committed zarr v3 model step,
    on the CPU at 32^2: the frame equals render_frame from load_model's
    params of the same step."""
    from mofanerf_tpu_torch.cli import run_render
    from mofanerf_tpu_torch.config import load_config
    from mofanerf_tpu_torch.ops.rays import pose_spherical
    from mofanerf_tpu_torch.render.renderer import (exp_code_for, prepare_conditioning,
                                                    render_frame)

    entry = _manifest()["steps"]["model_zarr3"]
    ckpt = tmp_path / "ckpt"
    shutil.copytree(os.path.join(ORBAX_FIXTURES, "model_zarr3"), ckpt)
    flags = [f"--{k}={v}" for k, v in entry["flags"].items()]
    with blocked():
        frames = run_render.main(["--out_dir", str(tmp_path / "out"), "--ckpt_dir", str(ckpt),
                                  "--n_views", "1", "--render_factor", "16",
                                  "--basedir", str(tmp_path / "logs"),
                                  "--uvdir", str(tmp_path / "uv"),
                                  "--shape_codes_path", str(tmp_path / "none.npy"),
                                  "--device", "cpu"] + flags)
    spec = load_config(flags).model_spec()
    params, step = ck.load_model(str(ckpt), spec, "cpu")
    assert step == int(entry["step"])
    zeros = lambda n: torch.zeros(n)
    cond = prepare_conditioning(params, spec, zeros(spec.shape_dim), exp_code_for(params, 0),
                                zeros(spec.tex_dim))
    K = np.array([[1200.0 / 16, 0, 16], [0, 1200.0 / 16, 16], [0, 0, 1]], np.float32)
    want = render_frame(params, spec, cond, 32, 32, K, pose_spherical(-180.0, 0.0, 16.0)[:3])
    assert frames.shape == (1, 32, 32, 3)
    np.testing.assert_array_equal(frames[0], want["rgb"].numpy())


@pytest.mark.parametrize("damage", ["shard_index_byte", "shard_cut", "numbered_missing",
                                    "numbered_byte", "zstd_dictionary", "blosc", "filters"])
def test_damaged_or_unread_steps_raise(tmp_path, damage):
    """A flipped byte of a shard's index (its CRC-32C no longer holds), a
    shard cut short, a numbered database whose numbered manifests are gone
    or whose newest has a flipped byte: ValueError, as tensorstore refuses
    them. A zstd chunk that needs a dictionary (tensorstore's zstd passes
    none, and refuses it too), the blosc compressor (tensorstore reads it;
    no Orbax handler writes it) and zarr filters (tensorstore refuses them):
    ValueError naming them."""
    import tensorstore as ts

    zarr3 = damage.startswith("shard")
    step = tmp_path / "000001"
    if damage.startswith("numbered"):
        write_variant(tmp_path / "src", variant_tree(4, sharded=False), True, True)
        numbered_copy(tmp_path / "src", step, batches=2)
        numbered = sorted(p for p in step.iterdir() if p.name.startswith("manifest.0"))
        if damage == "numbered_missing":
            for p in numbered:
                p.unlink()
        else:
            data = bytearray(numbered[-1].read_bytes())
            data[len(data) // 2] ^= 0x10
            numbered[-1].write_bytes(bytes(data))
        with pytest.raises(ValueError, match="none is there" if damage == "numbered_missing"
                           else "CRC-32C"):
            read_step(str(step))
        return
    write_variant(step, variant_tree(4, sharded=False), False, zarr3)
    if zarr3:
        shard = step / "w" / "c" / "0" / "0"
        data = bytearray(shard.read_bytes())
        if damage == "shard_index_byte":
            data[-7] ^= 0x01     # an index byte before the CRC-32C
        else:
            data = data[:len(data) // 2]
        shard.write_bytes(bytes(data))
        with pytest.raises(Exception):
            ts.open({"driver": "zarr3", "kvstore": _kvstore(step, False, "w")}).result() \
                .read().result()
        with pytest.raises(ValueError, match="CRC-32C|shorter|past"):
            read_step(str(step))
        return
    meta_path = step / "w" / ".zarray"
    meta = json.loads(meta_path.read_text())
    if damage == "zstd_dictionary":
        import zstandard

        block = np.zeros(meta["chunks"], np.float32).tobytes()
        samples = [np.random.default_rng(i).integers(0, 4, 512, np.uint8).tobytes()
                   for i in range(200)]
        d = zstandard.train_dictionary(1024, samples)
        frame = zstandard.ZstdCompressor(dict_data=d, write_dict_id=True).compress(block)
        (step / "w" / "0.0").write_bytes(frame)
        with pytest.raises(Exception):
            ts.open({"driver": "zarr", "kvstore": _kvstore(step, False, "w")}).result() \
                .read().result()
        match = "dictionary"
    elif damage == "blosc":
        meta["compressor"] = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}
        meta_path.write_text(json.dumps(meta))
        match = "blosc"
    else:
        meta["filters"] = [{"id": "delta", "dtype": "<f4"}]
        meta_path.write_text(json.dumps(meta))
        match = "filters"
    with pytest.raises(ValueError, match=match):
        read_step(str(step))
