"""The port reads the JAX package's Orbax steps without Orbax
(mofanerf_tpu_torch/train/orbax.py, utils/ocdbt.py, utils/zstd.py).

Steps are written by `mofanerf_tpu.train.checkpoint.save_checkpoint` (Orbax
over tensorstore), and read back by the port with jax, orbax, tensorstore
and zstandard blocked: a narrow TrainState trained 2 steps by the JAX
package (so its Adam moments are not zero) bit for bit against
`bridge.train_state_to_torch` of the same state; a RefineState against
`bridge.refine_state_to_torch`; the params alone into a param tree; a tree
of bf16, f32 and int32 leaves in dicts, lists, tuples and NamedTuples; an
array sharded over the 8 virtual CPU devices (one zarr chunk a shard, each
chunk a frame of two zstd blocks); an all-zero array (RLE blocks); a zarr
array whose chunks do not divide its shape (edge chunks; written by
tensorstore's zarr driver into an OCDBT store, the layout Orbax uses); the
newest step of a directory holding both kinds; and corrupted files. The
zstd decoder is also held against the zstandard library's frames at several
levels, with and without checksums, and the OCDBT reader against
tensorstore's on a database of many small B-tree nodes."""
import contextlib
import json
import os
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mofanerf_tpu.train import refine as jref
from mofanerf_tpu.train import state as jstate
from mofanerf_tpu.train.checkpoint import save_checkpoint as jax_save
from mofanerf_tpu_torch import bridge
from mofanerf_tpu_torch.train import checkpoint as ck
from mofanerf_tpu_torch.train import refine as tref
from mofanerf_tpu_torch.train import state as tstate
from mofanerf_tpu_torch.train.orbax import read_step
from mofanerf_tpu_torch.utils import ocdbt, zstd
from mofanerf_tpu_torch.utils.tree import flatten_with_keystr
from tests.test_torch_train_state import _batch, _specs, jax_batch

BLOCKED = ("jax", "jaxlib", "orbax", "tensorstore", "zstandard", "mofanerf_tpu")


@contextlib.contextmanager
def blocked():
    """jax, orbax, tensorstore and zstandard cannot be imported, nor are they
    reachable through sys.modules, inside the block."""
    saved = {m: sys.modules[m] for m in list(sys.modules) if m.split(".")[0] in BLOCKED}

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    finder = Block()
    for m in saved:
        sys.modules[m] = None
    sys.meta_path.insert(0, finder)
    try:
        yield
    finally:
        sys.meta_path.remove(finder)
        sys.modules.update(saved)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(got, want):
    g, w = flatten_with_keystr(got), flatten_with_keystr(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), k


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A JAX TrainState after 2 steps, saved at step 2."""
    jspec, tspec = _specs()
    tx = jstate.make_optimizer()
    state = jstate.create_train_state(jax.random.PRNGKey(0), jspec)
    step = jax.jit(lambda s, b, k: jstate.train_step(s, b, k, jspec, tx))
    for i in range(2):
        state, _ = step(state, jax_batch(_batch(i)), jax.random.PRNGKey(i))
    d = tmp_path_factory.mktemp("orbax_train")
    jax_save(str(d), state, 2)
    return d, state, tspec


def test_train_state_restores_bit_exact_with_jax_blocked(trained):
    d, state, tspec = trained
    assert float(jnp.abs(state.opt_state[0].nu["fine"]["view"]["b"]).max()) > 0
    target = tstate.create_train_state(torch.Generator().manual_seed(3), tspec, device="cpu")
    assert ck.latest_step(str(d)) == 2
    with blocked():
        got = ck.restore_checkpoint(str(d), target, spec=tspec)
    want = bridge.train_state_to_torch(_np(state), tspec, "cpu")
    assert int(got.step) == 2 and int(got.opt_state.count) == 2
    _assert_trees_equal(ck._as_tree(got), ck._as_tree(want))


def test_params_only_target(trained):
    d, state, tspec = trained
    target = tstate.create_train_state(torch.Generator().manual_seed(3), tspec,
                                       device="cpu").params
    with blocked():
        got = ck.restore_checkpoint(str(d), target, spec=tspec)
        params, step = ck.load_model(str(d), tspec, "cpu")
    want = bridge.model_params_to_torch(_np(state.params), tspec, "cpu")
    _assert_trees_equal(got, want)
    _assert_trees_equal(params, want)
    assert step == 2
    with pytest.raises(ValueError, match="spec"):
        ck.restore_checkpoint(str(d), target)


def test_refine_state_restores_bit_exact(tmp_path):
    small = dict(ngf=4, ndf=4, n_downsampling=1, n_blocks=1, num_D=2, n_layers_D=1)
    jcfg, tcfg = jref.RefineConfig(**small), tref.RefineConfig(**small)
    state = jax.jit(lambda k: jref.init_refine_state(k, jcfg, image_size=16))(
        jax.random.PRNGKey(0))
    # moments that are not zero, a count of 3
    bump = lambda o: (o[0]._replace(count=jnp.int32(3),
                                    mu=jax.tree.map(lambda x: x + 0.5, o[0].mu),
                                    nu=jax.tree.map(lambda x: x + 0.25, o[0].nu)),
                      o[1]._replace(count=jnp.int32(3)))
    state = state._replace(g_opt=bump(state.g_opt), d_opt=bump(state.d_opt), step=jnp.int32(3))
    jax_save(str(tmp_path), state, 3)
    target = tref.init_refine_state(torch.Generator().manual_seed(1), tcfg, device="cpu")
    with blocked():
        got = ck.restore_checkpoint(str(tmp_path), target, spec=tcfg)
    want = bridge.refine_state_to_torch(_np(state), tcfg, "cpu")
    _assert_trees_equal(tref.refine_tree(got), tref.refine_tree(want))
    assert int(got.g_opt.count) == 3


class Pair(NamedTuple):
    a: jnp.ndarray
    b: jnp.ndarray


def test_leaf_types_and_containers(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"bf": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
            "f": jnp.asarray(rng.standard_normal((4,)), jnp.float32),
            "i": jnp.asarray(rng.integers(-9, 9, (2, 3)), jnp.int32),
            "scalar": jnp.int32(7),
            "l": [jnp.ones(2), {"x": jnp.arange(3)}],
            "t": (jnp.zeros(1), Pair(jnp.full((2,), 2.0), jnp.asarray([1, 2], jnp.int32))),
            "empty": optax.EmptyState()}
    jax_save(str(tmp_path), tree, 1)
    with blocked():
        got = read_step(str(tmp_path / "000001"))
    assert got["bf"].dtype == torch.bfloat16
    assert torch.equal(got["bf"].view(torch.int16),
                       torch.from_numpy(np.asarray(tree["bf"]).view(np.int16).copy()))
    for k in ("f", "i", "scalar"):
        assert torch.equal(got[k], torch.from_numpy(np.asarray(tree[k]))), k
    assert isinstance(got["l"], list) and torch.equal(got["l"][1]["x"], torch.arange(3).int())
    pair = got["t"][1]
    assert torch.equal(pair.a, torch.full((2,), 2.0)) and pair.b.dtype == torch.int32
    assert got["empty"] is None


def test_sharded_multichunk_and_zero_arrays(tmp_path):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    x = np.random.default_rng(1).standard_normal((8 * 40, 1000)).astype(np.float32)
    tree = {"x": jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("d"))),
            "z": jnp.zeros((300, 300), jnp.float32)}
    jax_save(str(tmp_path), tree, 1)
    zstd.STATS.clear()
    with blocked():
        got = read_step(str(tmp_path / "000001"))
    assert torch.equal(got["x"], torch.from_numpy(x))
    assert torch.equal(got["z"], torch.zeros(300, 300))
    # one chunk a shard (8 frames of two compressed blocks: 160 KB each); RLE zeros
    assert zstd.STATS["block_compressed"] >= 16 and zstd.STATS["block_rle"] >= 1


def test_edge_chunks(tmp_path):
    import tensorstore as ts

    step = tmp_path / "000004"
    a = np.random.default_rng(2).standard_normal((37, 29)).astype(np.float32)
    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{step}/",
                                                 "path": "w/"},
                   "metadata": {"shape": [37, 29], "chunks": [16, 16], "dtype": "<f4",
                                "compressor": {"id": "zstd", "level": 3}}},
                  create=True).result()
    arr[...] = a
    (step / "_METADATA").write_text(json.dumps({
        "tree_metadata": {"('w',)": {"key_metadata": [{"key": "w", "key_type": 2}],
                                     "value_metadata": {"value_type": "jax.Array",
                                                        "skip_deserialize": False}}},
        "use_ocdbt": True, "use_zarr3": False}))
    with blocked():
        got = read_step(str(step))
    assert torch.equal(got["w"], torch.from_numpy(a))


def test_newest_step_of_either_kind_and_the_tie(trained, tmp_path):
    d, state, tspec = trained
    import shutil

    shutil.copytree(d / "000002", tmp_path / "000002")
    target = tstate.create_train_state(torch.Generator().manual_seed(3), tspec, device="cpu")
    ck.save_checkpoint(str(tmp_path), target, 1)
    assert ck.latest_step(str(tmp_path)) == 2           # the Orbax step is newer
    got = ck.restore_checkpoint(str(tmp_path), target, spec=tspec)
    assert int(got.step) == 2
    ck.save_checkpoint(str(tmp_path), target, 2)       # a tie: the .pt is read
    assert ck.latest_step(str(tmp_path)) == 2
    got = ck.restore_checkpoint(str(tmp_path), target, spec=tspec)
    assert int(got.step) == int(target.step)
    os.makedirs(tmp_path / "000009")                    # not a finished Orbax step
    assert ck.latest_step(str(tmp_path)) == 2


@pytest.mark.parametrize("damage", ["node_byte", "truncated_values"])
def test_corrupted_step_raises(trained, tmp_path, damage):
    import shutil

    d, _, tspec = trained
    step = tmp_path / "000002"
    shutil.copytree(d / "000002", step)
    files = sorted((step / "ocdbt.process_0" / "d").iterdir(), key=lambda p: p.stat().st_size)
    if damage == "node_byte":   # the root B-tree node: its CRC-32C no longer holds
        path = next((step / "d").iterdir())
        data = bytearray(path.read_bytes())
        data[len(data) // 2] ^= 0x40
        path.write_bytes(bytes(data))
        match = "CRC-32C"
    else:   # the values' data file loses its tail
        path = files[-1]
        path.write_bytes(path.read_bytes()[:path.stat().st_size // 2])
        match = "past its"
    with pytest.raises(ValueError, match=match):
        read_step(str(step))


@pytest.mark.parametrize("level", [1, 3, 19, -3])
def test_zstd_against_zstandard(level):
    import zstandard

    rng = np.random.default_rng(level + 10)
    cases = [b"", b"a", b"abcabcabc" * 50,
             b"".join(b"row %d of the table, value %d; " % (i, i * i % 97) for i in range(5000)),
             rng.integers(0, 256, 200000, dtype=np.uint8).tobytes(),
             bytes(300000),
             rng.standard_normal(70000).astype(np.float32).tobytes(),
             rng.choice(np.arange(30, dtype=np.uint8), 150000).tobytes()]
    frames = []
    for i, data in enumerate(cases):
        cctx = zstandard.ZstdCompressor(level=level, write_checksum=i % 2 == 0,
                                        write_content_size=i % 3 != 0)
        frames.append((data, cctx.compress(data)))
    zstd.STATS.clear()
    with blocked():
        for data, frame in frames:
            assert zstd.decompress(frame) == data
        both = frames[3][1] + frames[4][1]
        assert zstd.decompress(both) == frames[3][0] + frames[4][0]
    assert zstd.STATS["checksum"] >= 4 and zstd.STATS["block_compressed"] > 0
    bad = bytearray(frames[3][1])
    bad[-1] ^= 1   # the checksum's last byte
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(bad))


def test_zstd_reaches_every_mode():
    """Across levels the frames reach each block, literals and table mode."""
    import zstandard

    rng = np.random.default_rng(5)
    data = [b"".join(b"the quick brown fox %d jumps over the lazy dog. " % i for i in range(6000)),
            bytes(200000), rng.integers(0, 256, 150000, dtype=np.uint8).tobytes(),
            rng.standard_normal(60000).astype(np.float32).tobytes(), b"hello hello hello world",
            np.arange(100000, dtype=np.int32).tobytes(),
            rng.choice(np.arange(40, dtype=np.uint8), 300000,
                       p=np.r_[0.5, np.full(39, 0.5 / 39)]).tobytes()]
    zstd.STATS.clear()
    for level in (1, 9, 19):
        for d in data:
            assert zstd.decompress(zstandard.ZstdCompressor(level=level).compress(d)) == d
    seen = set(zstd.STATS)
    assert {"block_raw", "block_rle", "block_compressed", "literals_raw", "literals_rle",
            "literals_huffman", "literals_treeless", "huffman_1_streams", "huffman_4_streams",
            "fse_predefined", "fse_rle", "fse_compressed", "fse_repeat"} <= seen, seen


def test_xxh64_and_crc32c_known_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    assert ocdbt.crc32c(b"123456789") == 0xE3069283


def test_ocdbt_interior_nodes_against_tensorstore(tmp_path):
    import tensorstore as ts

    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": {"max_decoded_node_bytes": 600, "max_inline_value_bytes": 16}}
    kv = ts.KvStore.open(spec).result()
    want = {b"key%04d" % i: bytes([i % 251]) * (i % 40) for i in range(150)}
    for k, v in want.items():
        kv.write(k, v).result()
    with blocked():
        db = ocdbt.Database(str(tmp_path))
        got = {k: db.value(ref) for k, ref in db.entries().items()}
    assert db.height >= 2 and got == want
