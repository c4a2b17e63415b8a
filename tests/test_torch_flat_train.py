"""The train step's flat optimizer (ops/flat_adam.py, train/state.py) and
fused field layers (ops/fused_linear.py), and the kernels' alignment rule
(ops/field_kernel.py, ops/serve_kernel.py).

On the CPU:
- the flat update, finite check and select against the per-leaf Adam and
  the per-leaf `torch.where` skip they replaced (kept here as the plain
  version), over several steps, two of them non-finite: bit for bit;
- `FlatLayout`: every leaf starts 256 bytes after the buffer's start;
- a train step and a chunk of steps leave the state they were given
  unwritten, and the state they return shares no storage with it; the
  host-data loop copies its state once a run;
- the fused layer's plain version, and the CPU route of the field, which
  keeps `_layer` then ReLU;
- B1's and B2's packs: operands that are views at a 4-byte offset reach the
  kernels as aligned copies, aligned ones pass uncopied, and the checks
  refuse an unaligned operand.

On the card (`cuda`): the fused layer's output and gradients (input,
weight, bias, both products of the skip layer) against `_layer` + ReLU and
an f32 reference at the coarse (65,536 x 256) and fine (131,072 x 1024)
shapes, the embedding's 63-wide input too; the flat Adam and finite-check
kernels against their plain versions; a bf16 chunk of steps on the kernels
with no host synchronisation; B1 from parameters that are views at a
4-byte offset."""
import contextlib
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mofanerf_tpu_torch.config import Config
from mofanerf_tpu_torch.data.device_data import DeviceDataset, DeviceSamplerConfig
from mofanerf_tpu_torch.models import field as tfield
from mofanerf_tpu_torch.models.field import FieldConfig, init_field_params
from mofanerf_tpu_torch.models.student import StudentConfig, init_student_params
from mofanerf_tpu_torch.ops import field_kernel as fk
from mofanerf_tpu_torch.ops import flat_adam
from mofanerf_tpu_torch.ops import fused_linear as fl
from mofanerf_tpu_torch.ops import serve_kernel as sk
from mofanerf_tpu_torch.ops.flat_adam import ALIGN, FlatLayout
from mofanerf_tpu_torch.ops.rays import pose_spherical
from mofanerf_tpu_torch.train import loop
from mofanerf_tpu_torch.train import state as tstate
from mofanerf_tpu_torch.utils.tree import map_tree, tree_leaves, tree_unflatten

SHAPES = [(5, 3), (4,), (2, 2), (1,), (70,), (3, 7, 2)]


# ---- the plain per-leaf optimizer the flat one replaced ------------------------------------

def per_leaf_update(tx, grads, count, mu, nu, params):
    """Adam.update as it was: out-of-place _foreach ops over the leaves."""
    b1, b2 = tx.b1, tx.b2
    mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1), torch._foreach_mul(mu, b1))
    sq = torch._foreach_mul(grads, grads)
    nu = torch._foreach_add(torch._foreach_mul(sq, 1 - b2), torch._foreach_mul(nu, b2))
    new_count = count + 1
    t = new_count.to(torch.float32)
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), tx.eps)
    upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    upd = torch._foreach_mul(upd, -tx.rate(count))
    return torch._foreach_add(params, upd), mu, nu, new_count


def per_leaf_step(tx, grads, loss, count, mu, nu, params):
    """The update, the check over a `torch.cat` of every gradient and the three
    per-leaf `torch.where` lists of the old train_step."""
    new_p, new_mu, new_nu, new_count = per_leaf_update(tx, grads, count, mu, nu, params)
    ok = torch.isfinite(loss) & torch.isfinite(torch.cat([g.reshape(-1) for g in grads])).all()

    def pick(new, old):
        return [torch.where(ok, n, o) for n, o in zip(new, old)]

    return (pick(new_p, params), pick(new_mu, mu), pick(new_nu, nu),
            torch.where(ok, new_count, count), ok)


@pytest.mark.parametrize("lrate_decay", [250, None])
def test_flat_update_check_and_select_match_the_per_leaf_ones(lrate_decay):
    g = torch.Generator().manual_seed(0)
    params = [torch.randn(s, generator=g) for s in SHAPES]
    tx = tstate.Adam(lrate=1e-2, lrate_decay=lrate_decay)
    layout = FlatLayout.of(params)
    p, mu, nu = layout.pack(params), layout.zeros("cpu"), layout.zeros("cpu")
    count = torch.zeros((), dtype=torch.int32)
    flag = torch.ones((), dtype=torch.int32)
    ref_p, ref_mu, ref_nu = list(params), [torch.zeros(s) for s in SHAPES], \
        [torch.zeros(s) for s in SHAPES]
    ref_count = count.clone()
    for k in range(6):
        grads = [torch.randn(s, generator=g) * 10.0 ** (k % 3 - 1) for s in SHAPES]
        loss = torch.tensor(1.0)
        if k == 2:
            grads[4][17] = float("nan")
        if k == 4:
            loss = torch.tensor(float("inf"))
        gflat = layout.pack(grads)
        kept = [x.clone() for x in (p, mu, nu)]
        flat_adam.all_finite(gflat, loss, flag)
        tx.apply_(p, mu, nu, gflat, count, flag)
        ref_p, ref_mu, ref_nu, ref_count, ok = per_leaf_step(tx, grads, loss, ref_count, ref_mu,
                                                             ref_nu, ref_p)
        assert bool(flag) == bool(ok) == (k not in (2, 4))
        assert int(count) == int(ref_count) == k + 1 - (k >= 2) - (k >= 4)
        for buf, ref in ((p, ref_p), (mu, ref_mu), (nu, ref_nu)):
            for a, b in zip(layout.views(buf), ref):
                assert torch.equal(a, b)
        if not ok:   # a skipped step keeps params and moments bit for bit
            for a, b in zip((p, mu, nu), kept):
                assert torch.equal(a, b)
        # the gaps between leaves stay zero
        for buf in (p, mu, nu):
            mask = torch.ones(layout.size, dtype=torch.bool)
            for off, s in zip(layout.offsets, layout.shapes):
                mask[off:off + int(np.prod(s))] = False
            assert not buf[mask].any()


def test_the_leaf_api_matches_the_per_leaf_update_and_leaves_its_inputs():
    g = torch.Generator().manual_seed(1)
    params = {"a": torch.randn(SHAPES[0], generator=g),
              "b": [torch.randn(s, generator=g) for s in SHAPES[1:]]}
    tx = tstate.make_optimizer(5e-5, 0.1)
    state = tx.init(params)
    leaves = tree_leaves(params)
    before = [x.clone() for x in leaves + tree_leaves(state.mu) + tree_leaves(state.nu)]
    grads = [torch.randn(x.shape, generator=g) for x in leaves]
    new_p, mu, nu, count = tx.update(grads, state, leaves)
    ref = per_leaf_update(tx, grads, state.count, tree_leaves(state.mu), tree_leaves(state.nu),
                          leaves)
    for got, want in zip((new_p, mu, nu), ref[:3]):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert int(count) == int(ref[3]) == 1 and int(state.count) == 0
    for a, b in zip(leaves + tree_leaves(state.mu) + tree_leaves(state.nu), before):
        assert torch.equal(a, b)


def test_every_leaf_starts_256_bytes_apart():
    params = init_field_params(torch.Generator().manual_seed(0),
                               FieldConfig(depth=4, width=24, skip=1, multires=3), device="cpu")
    leaves = tree_leaves(params)
    layout = FlatLayout.of(leaves)
    assert ALIGN * 4 == 256 and layout.size % ALIGN == 0
    assert all(off % ALIGN == 0 for off in layout.offsets)
    flat = layout.pack(leaves)
    views = layout.views(flat)
    for v, leaf, off in zip(views, leaves, layout.offsets):
        assert (v.data_ptr() - flat.data_ptr()) == 4 * off and (4 * off) % 256 == 0
        assert v.is_contiguous() and torch.equal(v, leaf)
    # Adam's moments from init are views of flat buffers of the same layout
    state = tstate.make_optimizer().init(params)
    mu = tree_leaves(state.mu)
    assert all((m.data_ptr() - mu[0].data_ptr()) == 4 * off
               for m, off in zip(mu, layout.offsets))


def _trainer(device, dtype="float32", n_rand=16, hw=16):
    """A tiny model, its train state and a random split resident on `device`;
    `chunk(state, i0, n)` runs train_chunk_device_data."""
    cfg = Config(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, multires=4,
                 multires_views=2, N_samples=4, N_importance=4, N_rand=n_rand, uv_size=128,
                 compute_dtype=dtype)
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
    state = tstate.create_train_state(torch.Generator().manual_seed(0), spec, device=device)
    K = torch.tensor([[30.0, 0, hw / 2], [0, 30.0, hw / 2], [0, 0, 1]], device=device)

    def chunk(state, i0, n_steps):
        return loop.train_chunk_device_data(state, dd, K, i0, n_steps, scfg, spec,
                                            tstate.make_optimizer(), seed=5)
    return state, chunk, dd, K, scfg, spec


def _all(state):
    return tree_leaves(state.params) + tree_leaves(state.opt_state.mu) + \
        tree_leaves(state.opt_state.nu) + [state.opt_state.count, state.step]


def _storages(state):
    return {t.untyped_storage().data_ptr() for t in _all(state)}


def _check_unwritten(state, snapshot, new):
    for a, b in zip(_all(state), snapshot):
        assert torch.equal(a, b)
    assert not _storages(state) & _storages(new)


def test_a_chunk_and_a_step_leave_the_state_they_were_given_unwritten():
    state, chunk, dd, K, scfg, spec = _trainer("cpu")
    snapshot = [t.clone() for t in _all(state)]
    s1, _ = chunk(state, 0, 1)
    _check_unwritten(state, snapshot, s1)
    snap1 = [t.clone() for t in _all(s1)]
    s3, m = chunk(s1, 1, 2)
    _check_unwritten(s1, snap1, s3)
    _check_unwritten(state, snapshot, s3)
    assert int(s3.step) == 3 and bool(m["step_ok"])
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(s3.params),
                                                      tree_leaves(s1.params)))
    # a lone step too, and it takes the same step as a chunk of one from the same state
    batch = loop.sample_batch_device(dd, K, 3, scfg, loop.device_generator(5, 3, 0, "cpu"))
    s4, _ = tstate.train_step(s3, batch, loop.device_generator(5, 3, 1, "cpu"), spec,
                              tstate.make_optimizer())
    snap3 = [t.clone() for t in _all(s3)]
    c4, _ = chunk(s3, 3, 1)
    _check_unwritten(s3, snap3, s4)
    for a, b in zip(_all(s4), _all(c4)):
        assert torch.equal(a, b)


def test_the_host_data_loop_copies_the_state_once_a_run(tmp_path, monkeypatch):
    """run_train on host batches makes one FlatTrainState for the run and
    steps it in place: every step updates, and the checkpoints it saves on
    the way and at the end hold the state of their step."""
    from mofanerf_tpu_torch.cli import run_train
    from mofanerf_tpu_torch.config import load_config
    from mofanerf_tpu_torch.data.facescape import make_synthetic_dataset
    from mofanerf_tpu_torch.train.checkpoint import restore_checkpoint

    made = []

    class Counted(tstate.FlatTrainState):
        def __init__(self, state):
            made.append(int(state.step))
            super().__init__(state)

    monkeypatch.setattr(loop, "FlatTrainState", Counted)
    d = tmp_path / "data"
    make_synthetic_dataset(str(d), n_ids=2, n_train=2, n_test=1, hw=32)
    flags = ["--basedir", str(tmp_path / "logs"), "--expname", "flat", "--datadir", str(d),
             "--uvdir", str(d / "uv"), "--shape_codes_path", str(d / "factors_id.npy"),
             "--landmarks_path", str(d / "landmarks.npy"), "--netdepth", "2", "--netwidth",
             "32", "--netdepth_fine", "2", "--netwidth_fine", "32", "--multires", "4",
             "--multires_views", "2", "--N_rand", "16", "--N_samples", "4", "--N_importance",
             "4", "--uv_size", "128", "--person_num", "2", "--i_print", "1", "--i_weights",
             "2", "--i_testset", "100", "--i_video", "100", "--i_grid", "0", "--device", "cpu"]
    final = run_train.main(flags + ["--n_iters", "3"])
    assert made == [0]
    assert int(final.step) == 3 and int(final.opt_state.count) == 3
    ckpt = tmp_path / "logs" / "flat" / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["000002.pt", "000003.pt"]
    like = tstate.create_train_state(torch.Generator().manual_seed(1),
                                     load_config(flags).model_spec(), device="cpu")
    two = restore_checkpoint(str(ckpt), like, step=2)
    three = restore_checkpoint(str(ckpt), like, step=3)
    assert int(two.step) == 2 and int(three.step) == 3
    for a, b in zip(tree_leaves(three.params), tree_leaves(final.params)):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(two.params),
                                                      tree_leaves(three.params)))


def test_the_fused_layer_plain_version_and_the_cpu_route():
    g = torch.Generator().manual_seed(2)
    bf16 = torch.bfloat16
    x = torch.randn((33, 20), generator=g).to(bf16).requires_grad_()
    x2 = torch.randn((33, 12), generator=g).to(bf16).requires_grad_()
    w, w2 = torch.randn((20, 40), generator=g), torch.randn((12, 40), generator=g)
    b = torch.randn(40, generator=g)
    for t in (w, w2, b):
        t.requires_grad_()
    y = fl.linear_relu([(x, w), (x2, w2)], b)
    # the first product with the bf16 bias rounded once, the second summed onto it
    first = (x.float() @ w.to(bf16).float() + b.to(bf16).float()).to(bf16)
    want = F.relu((first.float() + x2.float() @ w2.to(bf16).float()).to(bf16))
    assert y.dtype == bf16 and torch.equal(y, want)
    grads = torch.autograd.grad(y.float().sum(), (x, w, b, x2, w2))
    assert all(gr is not None and torch.isfinite(gr).all() for gr in grads)
    assert grads[1].dtype == torch.float32 and grads[0].dtype == bf16
    with pytest.raises(ValueError, match="one or two"):
        fl.linear_relu([], b)
    # on the CPU the field keeps _layer, then ReLU, bit for bit
    got = tfield._relu_layer([(x, w), (x2, w2)], b, bf16)
    assert torch.equal(got, F.relu(tfield._layer([(x, w), (x2, w2)], b, bf16)))


def test_the_card_route_glue_on_the_cpu_with_the_kernels_emulated(monkeypatch):
    """`LinearReLU` (its forward's library products, and the wrapper
    `relu_grad` around the Triton kernel) run on CPU tensors with the
    kernel's launch emulated by its plain arithmetic: shapes, dtypes,
    strides, the launch count and the gradients' routing."""
    def emulate(name, grid, cfg, *args, **consts):
        dy, y, dz, part, M, N = args
        dz.copy_(torch.where(y <= 0, 0, dy))
        if consts["HAS_DB"]:
            part.copy_(dz.float().reshape(grid[0], -1, N).sum(1))
        fl.launch_count[name] += 1

    monkeypatch.setattr(fl, "_launch", emulate)
    g = torch.Generator().manual_seed(5)
    bf16 = torch.bfloat16
    x = torch.randn((128, 20), generator=g).to(bf16).requires_grad_()
    x2 = torch.randn((128, 12), generator=g).to(bf16).requires_grad_()
    w, w2 = torch.randn((20, 40), generator=g), torch.randn((12, 40), generator=g)
    b = torch.randn(40, generator=g)
    for t in (w, w2, b):
        t.requires_grad_()
    dy = torch.randn((128, 40), generator=g).to(bf16)
    ins = (x, w, b, x2, w2)
    before = fl.launch_count["relu_grad"]
    y = fl.LinearReLU.apply(x, w, b, x2, w2)
    got = torch.autograd.grad(y, ins, dy)
    want_y = fl.linear_relu_ref([(x, w), (x2, w2)], b)
    want = torch.autograd.grad(want_y, ins, dy)
    assert torch.equal(y, want_y) and fl.launch_count["relu_grad"] == before + 1
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and a.shape == r.shape
        torch.testing.assert_close(a.float(), r.float(), rtol=2e-2, atol=2e-2)
    # one product, the embedded points (f32, no gradient) as its input
    pts = torch.randn((128, 7), generator=g)
    w1 = torch.randn((7, 40), generator=g, requires_grad=True)
    y1 = fl.LinearReLU.apply(pts, w1, b, None, None)
    dw1, db1 = torch.autograd.grad(y1, (w1, b), dy)
    dz = torch.where(y1 <= 0, 0, dy).float()
    torch.testing.assert_close(db1, dz.sum(0))
    torch.testing.assert_close(dw1, (pts.to(bf16).float().t() @ dz), rtol=2e-2, atol=2e-2)


# ---- alignment of the kernels' operands ----------------------------------------------------

def _offset_views(tree, offset_bytes=4):
    """The leaves of `tree` copied into one f32 buffer, each starting
    `offset_bytes` past a 16-byte boundary: views the kernels would fault on."""
    leaves = tree_leaves(tree)
    pad = offset_bytes // 4
    sizes = [-(-(x.numel() + pad) // 4) * 4 for x in leaves]
    flat = torch.zeros(sum(sizes) + 4)
    out, at = [], 0
    for x, n in zip(leaves, sizes):
        v = flat[at + pad:at + pad + x.numel()].view(x.shape)
        v.copy_(x)
        out.append(v)
        at += n
    return tree_unflatten(tree, out)


def test_b1_operands_that_are_offset_views_reach_the_kernel_as_copies():
    cfg = FieldConfig(depth=8, width=64, compute_dtype=torch.bfloat16)
    params = init_field_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    cond = tfield.fold_conditioning(params, torch.zeros(cfg.shape_dim), torch.zeros(cfg.exp_dim),
                                    torch.zeros(cfg.tex_dim))
    aligned = fk.pack_fused_params(params, cond, cfg)
    # an f32 operand whose shape is the kernel's passes uncopied when aligned
    assert aligned.b_view.data_ptr() == params["view"]["b"].data_ptr()
    off_params, off_cond = _offset_views(params), _offset_views(cond)
    assert off_params["view"]["b"].data_ptr() % 16 == 4
    packed = fk.pack_fused_params(off_params, off_cond, cfg)
    for name, t in packed._asdict().items():
        assert t.data_ptr() % 16 == 0, name
        assert torch.equal(t, getattr(aligned, name)), name
    assert packed.b_view.data_ptr() != off_params["view"]["b"].data_ptr()
    assert fk.rebias_fused_params(packed, off_cond, cfg).b_pts.data_ptr() % 16 == 0
    # the check refuses an unaligned operand, and the wrapper copies unaligned inputs
    pe = torch.zeros((8, cfg.pts_embed_dim))
    dirf = torch.zeros((2, cfg.width // 2))
    bad = packed._replace(b_view=_offset_views({"b": packed.b_view})["b"])
    with pytest.raises(ValueError, match="16-byte boundary"):
        fk._check_operands(bad, pe, dirf, cfg, 4)
    off_pe = _offset_views({"pe": pe})["pe"]
    rgb, sigma = fk.fused_field_apply(packed, off_pe, dirf, cfg, 4)
    want = fk.fused_field_apply(packed, pe, dirf, cfg, 4)
    assert torch.equal(rgb, want[0]) and torch.equal(sigma, want[1])


def test_b2_pack_operands_that_are_offset_views_are_copied(monkeypatch):
    cfg = StudentConfig(depth=2, width=32, multires=4, compute_dtype=torch.float32)
    params = init_student_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    pack = sk.pack_student(params, cfg)
    assert pack.bsig.data_ptr() == params["sigma"]["b"].data_ptr()   # aligned: uncopied
    off = _offset_views(params)
    assert off["sigma"]["b"].data_ptr() % 16 == 4
    packed = sk.pack_student(off, cfg)
    for name, t in packed._asdict().items():
        assert t.numel() == 0 or t.data_ptr() % 16 == 0, name
        assert torch.equal(t, getattr(pack, name)), name
    # the launch's check refuses an unaligned pack operand before anything runs
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(sk, "_library_uses_wgmma", lambda *a: False)
    bad = packed._replace(bsig=_offset_views({"b": packed.bsig})["b"])
    n = 4
    rays = torch.zeros((n, 3))
    aux, dirf = torch.zeros((n, 4)), torch.zeros((n, cfg.width // 2))
    with pytest.raises(ValueError, match="bsig does not start on a 16-byte boundary"):
        sk._serve_cuda(bad, aux, dirf, cfg, rays, rays, 8, False)


# ---- on the card ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Triton kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |a - ref| over the largest |ref|."""
    return float((a.detach().float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def layer_gaps(M, K, K2, N, gen):
    """The fused layer on the card at one shape, against an f32 reference of
    the same bf16 operands (the ReLU's mask taken from the layer's own
    output), beside `_layer` + ReLU's: {output: (its gap, the gap of
    `_layer` + ReLU, its tolerance)}. The bf16 outputs (y, the input and
    weight gradients) are held to two bf16 ulps of the largest reference
    value, the f32 bias gradient to 1e-4. A 63-wide input is the embedded
    points: f32, no gradient."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    pts = K == 63
    x = (torch.rand((M, K), generator=gen, device=dev) * 2).to(torch.float32 if pts else bf16)
    w = torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
    b = torch.randn((N,), generator=gen, device=dev) * 0.1
    x2 = (torch.rand((M, K2), generator=gen, device=dev) * 2).to(bf16) if K2 else None
    w2 = torch.randn((K2, N), generator=gen, device=dev) / max(K2, 1) ** 0.5 if K2 else None
    dy = (torch.randn((M, N), generator=gen, device=dev) * 1e-3).to(bf16)
    x.requires_grad_(not pts)
    for t in (w, b, x2, w2):
        if t is not None:
            t.requires_grad_()
    pairs = [(x, w)] + ([(x2, w2)] if K2 else [])
    ins = [t for t in (x, w, b, x2, w2) if t is not None and t.requires_grad]
    names = ([] if pts else ["dx"]) + ["dw", "db"] + (["dx2", "dw2"] if K2 else [])
    y = fl.linear_relu(pairs, b)
    got = dict(zip(names, torch.autograd.grad(y, ins, dy)), y=y)
    layer_y = F.relu(tfield._layer([(x.to(bf16), w)] + pairs[1:], b, bf16))
    layer = dict(zip(names, torch.autograd.grad(layer_y, ins, dy)), y=layer_y)
    with torch.no_grad():
        xf, wb = x.detach().to(bf16).float(), w.detach().to(bf16).float()
        yref = xf @ wb + b.detach()
        if K2:
            x2f, w2b = x2.detach().float(), w2.detach().to(bf16).float()
            yref += x2f @ w2b
        dz = dy.float() * (y > 0)
        ref = {"y": F.relu(yref), "dw": xf.t() @ dz, "db": dz.sum(0)}
        if not pts:
            ref["dx"] = dz @ wb.t()
        if K2:
            ref["dx2"], ref["dw2"] = dz @ w2b.t(), x2f.t() @ dz
    return {k: (_rel(got[k], r), _rel(layer[k], r), 1e-4 if k == "db" else 2 * 2.0 ** -8)
            for k, r in ref.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name,M,K,K2,N", [("coarse", 65536, 256, 0, 256),
                                           ("coarse_skip", 65536, 256, 256, 256),
                                           ("fine", 131072, 1024, 0, 1024),
                                           ("fine_skip", 131072, 1024, 1024, 1024),
                                           ("fine_pts", 131072, 63, 0, 1024)])
def test_cuda_fused_layer_matches_layer_and_relu(name, M, K, K2, N):
    _card()
    gaps = layer_gaps(M, K, K2, N, torch.Generator(device="cuda").manual_seed(7))
    bad = {k: v for k, v in gaps.items() if not v[0] <= v[2]}
    assert not bad, (name, bad)


@pytest.mark.cuda
def test_cuda_flat_adam_matches_its_plain_version():
    """The update and the check on the card against their plain versions at
    the teacher's ~25 M parameters, bit for bit: every gradient finite, one
    infinite, the loss NaN (state and count kept)."""
    dev = _card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    n = 25_000_000 // ALIGN * ALIGN
    p, mu, g = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    nu = torch.rand(n, generator=gen, device=dev) * 1e-3
    count = torch.full((), 7, dtype=torch.int32, device=dev)
    t = (count + 1).float()
    consts = (-torch.full((), 5e-5, device=dev), 1 - 0.9 ** t, 1 - 0.999 ** t)
    for bad in (None, "g", "loss"):
        gg, loss = g.clone(), torch.ones((), device=dev)
        if bad == "g":
            gg[n // 3] = float("inf")
        if bad == "loss":
            loss.fill_(float("nan"))
        outs = []
        for finite, adam in ((flat_adam.all_finite, flat_adam.adam_),
                             (flat_adam.all_finite_ref, flat_adam.adam_ref_)):
            bufs, c = [x.clone() for x in (p, mu, nu)], count.clone()
            flag = torch.ones((), dtype=torch.int32, device=dev)
            finite(gg, loss, flag)
            adam(*bufs, gg, c, *consts, flag, 0.9, 0.999, 1e-8)
            outs.append((bufs, int(c), int(flag)))
        (kb, kc, kf), (pb, pc, pf) = outs
        assert (kc, kf) == (pc, pf) == ((8, 1) if bad is None else (7, 0)), bad
        for a, r, x in zip(kb, pb, (p, mu, nu)):
            assert torch.equal(a, r), bad
            assert bad is None or torch.equal(a, x), bad


@pytest.mark.cuda
def test_cuda_bf16_chunk_runs_the_kernels_without_a_host_sync():
    dev = _card()
    state, chunk, _, _, _, spec = _trainer(dev, dtype="bfloat16", n_rand=64, hw=32)
    chunk(state, 0, 2)
    torch.cuda.synchronize()
    before = dict(fl.launch_count), dict(flat_adam.launch_count)
    snapshot = [t.clone() for t in _all(state)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, m = chunk(state, 2, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    _check_unwritten(state, snapshot, new)
    assert bool(m["step_ok"]) and int(new.step) == 5
    # every hidden layer of both fields is one fused op, whose backward is one relu_grad:
    # the embedding's layer, the xyz layers, and each trunk's first, mid, skip and post layers
    per_field = sum(1 + f.xyz_depth + 2 * (2 + f.skip + max(0, f.depth - f.skip - 2))
                    for f in (spec.coarse, spec.fine))
    assert fl.launch_count["relu_grad"] - before[0].get("relu_grad", 0) == 5 * per_field
    assert flat_adam.launch_count["adam"] - before[1].get("adam", 0) == 5
    assert flat_adam.launch_count["finite"] - before[1].get("finite", 0) == 5


@pytest.mark.cuda
def test_cuda_b1_renders_from_offset_views():
    """B1 at the fine field's width from parameters that are views 4 bytes past a
    16-byte boundary of one card buffer: no fault, the same outputs as from
    the aligned parameters, and its plain version's within the tolerance of
    tests/test_torch_field_kernel.py (contracting weights, atol 5e-3)."""
    dev = _card()
    cfg = FieldConfig(depth=10, width=1024, compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(4)
    params = map_tree(lambda w: w * 0.4, init_field_params(gen, cfg, device=dev))
    codes = [(torch.randn(n, generator=gen) * 0.3).to(dev) for n in (50, 30, 256)]
    leaves = tree_leaves(params)
    spans = [-(-(t.numel() + 1) // 4) * 4 for t in leaves]
    flat = torch.zeros(sum(spans) + 4, device=dev)
    views, at = [], 0
    for t, n in zip(leaves, spans):
        v = flat[at + 1:at + 1 + t.numel()].view(t.shape)
        v.copy_(t)
        views.append(v)
        at += n
    off = tree_unflatten(params, views)
    assert off["view"]["b"].data_ptr() % 16 == 4
    n_rays, spr = 133, 67
    pe = torch.randn((n_rays * spr, 63), generator=gen).to(dev)
    dirf = (torch.randn((n_rays, cfg.width // 2), generator=gen) * 0.1).to(dev)
    outs = []
    with torch.no_grad():
        for p in (off, params):
            fused = fk.pack_fused_params(p, tfield.fold_conditioning(p, *codes), cfg)
            outs.append(torch.cat(fk.fused_field_apply(fused, pe, dirf, cfg, spr), dim=-1))
        torch.cuda.synchronize()
        want = torch.cat(fk.fused_field_apply_ref(fused, pe, dirf, cfg, spr), dim=-1)
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0], want, rtol=0, atol=5e-3)
