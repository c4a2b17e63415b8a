"""Repeated runs of the port's texture-conditioning study
(mofanerf_tpu_torch/examples/texture_synthetic.py) at its one seed, and of the
JAX script's recipe (examples/texture_synthetic.py), to count how often the
teacher renders both cubes empty; and step-by-step checks of the port's
teacher on two devices. Not a test (pytest does not collect it).

    python tests/torch_texture_trials.py runs --out DIR --runs 8 --iters 800 \
        [--atomics] [--perturb FIRST [--init DIR/jax_init.pkl]] [--device cuda]
    python tests/torch_texture_trials.py jax --out DIR --runs 4 --perturb 1 \
        [--iters 2500] [--cores 2]                                    # the CPU, JAX
    python tests/torch_texture_trials.py track --out DIR --steps 300 --devices cuda cuda cpu
    python tests/torch_texture_trials.py grads --out DIR --steps 2000 --every 100

`runs` starts `--runs` copies of the study at once, each in its own process
(as chip_smoke.py's examples phase runs the studies), the kernels built once
before them: through the study's main() (deterministic algorithms), or with
`--atomics` through `texture_synthetic.study` in torch's default mode (the
card's atomics). With `--perturb FIRST`, run k starts from the teacher's
initial weights each times 1 + 1e-6 z (z ~ N(0, 1), numpy's generator at
FIRST + k, leaves in JAX's flatten order; 0 leaves them as they are): the
port's own seed-0 weights, or with `--init` the JAX script's, as `jax` wrote
them. Each run's row: whether it passed the study's colour gates, its last
logged PSNR, both renders' mean colours, and the share of each render's
pixels that are not background ("empty" when both shares are 0). Prints one
`[TRIALS]` JSON line and writes DIR/trials.json.

`jax` (on the CPU; imports the JAX package) renders the study's data once,
writes the JAX script's initial weights (`create_train_state` at
PRNGKey(0)) to DIR/jax_init.pkl, then trains the JAX script's recipe (its
spec, optimiser, batches from numpy's generator at 1 and keys PRNGKey(i)) in
`--runs` processes at once, run k from those weights perturbed by FIRST + k
as above, each pinned to `--cores` cores; each renders, applies the script's
gates and logs its loss and PSNR every 100 steps. Prints one `[JAXRUNS]`
JSON line and writes DIR/jax_runs.json.

`track` renders the study's dataset once (on the first device), then trains
the study's teacher for `--steps` steps on each device in turn from the same
initial weights, on the same batches and the same random numbers (drawn from
one CPU generator and copied to the device), recording every step's loss.
Prints one `[TRACK]` JSON line (each device's losses, and each device's
largest relative departure from the last device's over the first 10, 50, 100
and all steps) and writes DIR/track.json.

`grads` trains the teacher on the card as the study does, then recomputes one
step's loss and gradients from every `--every`-th state on the card and on
the CPU (same batch, same random numbers): their relative differences say
whether an op of the port departs from its CPU result along a real card
trajectory, up to and after a collapse. Prints one `[GRADS]` JSON line and
writes DIR/grads.json.
"""
import argparse
import json
import os
import pickle
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mofanerf_tpu_torch.examples import _scenes, texture_synthetic  # noqa: E402
from mofanerf_tpu_torch.render.renderer import train_draws  # noqa: E402
from mofanerf_tpu_torch.train.state import (TrainState, create_train_state,  # noqa: E402
                                            make_optimizer, train_step)
from mofanerf_tpu_torch.utils.image_io import imread  # noqa: E402
from mofanerf_tpu_torch.utils.tree import tree_leaves, tree_unflatten  # noqa: E402

OBJECT_SUM = 0.15    # an RGB sum (of 3) above this is not the black background
EPS = 1e-6           # relative size of a perturbation of the initial weights
LRATE = 1e-3         # the study's and the JAX script's


def object_share(png: str) -> float:
    """Share of a render's pixels whose RGB sum exceeds OBJECT_SUM."""
    rgb = imread(png).astype(np.float32)[..., :3] / 255.0
    return float((rgb.sum(-1) > OBJECT_SUM).mean())


def perturbed(tree, k: int):
    """`tree` (numpy or torch leaves) with each leaf times 1 + EPS z, z ~ N(0, 1)
    from numpy's generator at k, in JAX's flatten order; k = 0: `tree`."""
    if k == 0:
        return tree
    rng = np.random.default_rng(k)

    def one(a):
        if isinstance(a, torch.Tensor):
            z = torch.from_numpy(rng.standard_normal(tuple(a.shape))).to(a.device)
            return (a.double() * (1 + EPS * z)).to(a.dtype)
        a = np.asarray(a)
        return (a * (1 + EPS * rng.standard_normal(a.shape))).astype(a.dtype)
    return tree_unflatten(tree, [one(a) for a in tree_leaves(tree)])


def read_run(out: str, text: str, rc: int) -> dict:
    """A finished run's row, from its stdout and its files."""
    psnr = re.findall(r"iter (\d+) loss \S+ psnr (\S+)", text)
    row = {"rc": rc, "gates_ok": "TEXTURE CONTROL OK" in text,
           "last_logged": [int(psnr[-1][0]), float(psnr[-1][1])] if psnr else None}
    js = os.path.join(out, "texture_synthetic.json")
    if os.path.exists(js):
        with open(js) as f:
            res = json.load(f)
        row["mean_rgb"] = [res["mean_rgb_uv0"], res["mean_rgb_uv1"]]
    pngs = [os.path.join(out, f"tex{pid}.png") for pid in (0, 1)]
    row["object_share"] = [object_share(p) if os.path.exists(p) else None for p in pngs]
    row["empty"] = row["object_share"] == [0.0, 0.0]
    if rc and not row["gates_ok"]:
        row["error"] = text.strip().splitlines()[-1][:300] if text.strip() else ""
    return row


def start_runs(cmds, outs, cores=None):
    """Start each command with its output in <out>.log (pinned to its share of
    `cores` cores when given); wait for all; their rows."""
    procs = []
    for k, (cmd, out) in enumerate(zip(cmds, outs)):
        pin = None if cores is None else (lambda k=k: os.sched_setaffinity(
            0, range(k * cores, (k + 1) * cores)))
        log = open(out + ".log", "w")
        procs.append((out, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                                 preexec_fn=pin)))
    rows = []
    for out, log, proc in procs:
        rc = proc.wait()
        log.close()
        with open(log.name) as f:
            rows.append(read_run(out, f.read(), rc))
    return rows


def summary(rows: list, **head) -> dict:
    return dict(head, runs=len(rows), empty=sum(r["empty"] for r in rows),
                gates_failed=sum(not r["gates_ok"] for r in rows), rows=rows)


def runs(argv) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--runs", type=int, default=8)
    p.add_argument("--iters", type=int, default=800)
    p.add_argument("--device", default="cuda")
    p.add_argument("--atomics", action="store_true")
    p.add_argument("--perturb", type=int, default=None)
    p.add_argument("--init", default=None)
    args = p.parse_args(argv)
    if args.device.startswith("cuda"):
        from mofanerf_tpu_torch.utils import cuda_build

        cuda_build.build_all()
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    outs = [os.path.join(args.out, f"run{k}") for k in range(args.runs)]
    cmds = []
    for k, out in enumerate(outs):
        cmd = [sys.executable, os.path.abspath(__file__), "one", out, "--iters",
               str(args.iters), "--device", args.device]
        cmd += ["--atomics"] if args.atomics else []
        cmd += [] if args.perturb is None else ["--perturb", str(args.perturb + k)]
        cmd += [] if args.init is None else ["--init", args.init]
        cmds.append(cmd)
    rows = start_runs(cmds, outs)
    result = summary(rows, iters=args.iters, atomics=args.atomics, perturb=args.perturb,
                     init="jax" if args.init else "port",
                     device=_scenes.device_name(torch.device(args.device)),
                     wall_secs=time.perf_counter() - t0)
    print("[TRIALS] " + json.dumps(result), flush=True)
    with open(os.path.join(args.out, "trials.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def one(argv) -> None:
    """One run of the study (a process of `runs`)."""
    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--iters", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--atomics", action="store_true")
    p.add_argument("--perturb", type=int, default=0)
    p.add_argument("--init", default=None)
    args = p.parse_args(argv)
    if args.perturb or args.init:
        jax_params = None
        if args.init:
            with open(args.init, "rb") as f:
                jax_params = pickle.load(f)

        def create(generator, spec, lrate, device="cuda"):
            from mofanerf_tpu_torch import bridge

            state = create_train_state(generator, spec, lrate=lrate, device=device)
            params = state.params
            if jax_params is not None:
                params = bridge.model_params_to_torch(perturbed(jax_params, args.perturb),
                                                      spec, device)
            else:
                params = perturbed(params, args.perturb)
            return TrainState(params, make_optimizer(lrate).init(params), state.step)
        _scenes.create_train_state = create
    if args.atomics:
        texture_synthetic.study(args.out, args.iters, 64, _scenes.resolve_device(args.device))
    else:
        texture_synthetic.main([args.out, "--iters", str(args.iters), "--device", args.device])


def jax_runs(argv) -> dict:
    import jax

    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--runs", type=int, default=4)
    p.add_argument("--perturb", type=int, default=1)
    p.add_argument("--iters", type=int, default=2500)
    p.add_argument("--cores", type=int, default=2)
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    data = os.path.join(args.out, "data")
    os.makedirs(data, exist_ok=True)
    texture_synthetic.render_colored_cubes(data, 64, torch.device("cpu"))
    with open(os.path.join(args.out, "jax_init.pkl"), "wb") as f:
        pickle.dump(_jax_init(), f)
    t0 = time.perf_counter()
    outs = [os.path.join(args.out, f"jax{k}") for k in range(args.runs)]
    cmds = [[sys.executable, os.path.abspath(__file__), "jax-one", out, "--iters",
             str(args.iters), "--perturb", str(args.perturb + k)] for k, out in enumerate(outs)]
    rows = start_runs(cmds, outs, cores=args.cores)
    result = summary(rows, iters=args.iters, perturb=args.perturb, device="cpu (JAX)",
                     wall_secs=time.perf_counter() - t0)
    print("[JAXRUNS] " + json.dumps(result), flush=True)
    with open(os.path.join(args.out, "jax_runs.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def _jax_spec():
    """The JAX script's teacher (examples/texture_synthetic.py)."""
    from mofanerf_tpu.models.field import FieldConfig
    from mofanerf_tpu.render.renderer import MoFaNeRF, RenderConfig

    return MoFaNeRF(coarse=FieldConfig(depth=8, width=64), fine=FieldConfig(depth=8, width=128),
                    render=RenderConfig(n_coarse=32, n_importance=32, packet_size=4096,
                                        raw_noise_std=1.0), uv_size=128)


def _plain(tree):
    """Mappings (flax's too) as dicts, leaves as numpy arrays."""
    if hasattr(tree, "keys"):
        return {k: _plain(tree[k]) for k in tree.keys()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return np.asarray(tree)


def _jax_init():
    import jax

    from mofanerf_tpu.train.state import create_train_state as jax_create

    return _plain(jax_create(jax.random.PRNGKey(0), _jax_spec(), lrate=LRATE).params)


def jax_one(argv) -> None:
    """The JAX script's loop, render and gates from its perturbed initial
    weights (a process of `jax`)."""
    import imageio.v2 as imageio
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from mofanerf_tpu.data.facescape import load_facescape_data
    from mofanerf_tpu.ops.rays import get_rays_at
    from mofanerf_tpu.render.renderer import (encode_texture, exp_code_for,
                                              prepare_conditioning, render_frame)
    from mofanerf_tpu.train.state import Batch
    from mofanerf_tpu.train.state import TrainState as JaxState
    from mofanerf_tpu.train.state import make_optimizer as jax_optimizer
    from mofanerf_tpu.train.state import train_step as jax_step

    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--iters", type=int, required=True)
    p.add_argument("--perturb", type=int, required=True)
    args = p.parse_args(argv)
    out, data = args.out, os.path.join(os.path.dirname(args.out), "data")
    os.makedirs(out, exist_ok=True)
    ds = load_facescape_data(data, [0, 1], np.zeros((300, 50), np.float32), testskip=1)
    H, W, focal = ds.hwf
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    spec, tx = _jax_spec(), jax_optimizer(lrate=LRATE)
    with open(os.path.join(os.path.dirname(out), "jax_init.pkl"), "rb") as f:
        params = jax.tree.map(jnp.asarray, perturbed(pickle.load(f), args.perturb))
    state = JaxState(params, tx.init(params), jnp.asarray(0, jnp.int32))
    step = jax.jit(lambda s, b, k: jax_step(s, b, k, spec, tx))
    rng = np.random.default_rng(1)
    colors = {0: _scenes.RED, 1: _scenes.BLUE}
    uvs = {pid: jnp.asarray(_scenes.flat_uv(c)) for pid, c in colors.items()}
    imgs = {}

    def batch():
        ii = int(rng.choice(ds.i_split[0]))
        if ii not in imgs:
            imgs[ii] = imageio.imread(ds.image_paths[ii]).astype(np.float32)[..., :3] / 255.
        t = imgs[ii]
        fr, fc = np.nonzero(t.sum(-1) > 0.05)
        nf = min(614, fr.shape[0])
        pick = rng.integers(0, fr.shape[0], nf)
        coords = np.concatenate([np.stack([fr[pick], fc[pick]], -1),
                                 np.stack([rng.integers(0, H, 1024 - nf),
                                           rng.integers(0, W, 1024 - nf)], -1)], 0)
        ro, rd = get_rays_at(jnp.asarray(coords, jnp.float32), jnp.asarray(K),
                             jnp.asarray(ds.poses[ii]))
        return Batch(ro, rd, jnp.asarray(t[coords[:, 0], coords[:, 1]]), jnp.zeros(50),
                     jnp.asarray(0), uvs[int(ds.id_codes[ii])])

    t0 = time.time()
    for i in range(args.iters):
        state, m = step(state, batch(), jax.random.PRNGKey(i))
        if i % 100 == 0 or i == args.iters - 1:
            print(f"[JAX] iter {i} loss {float(m['loss']):.4f} psnr {float(m['psnr']):.2f} "
                  f"({(i + 1) / (time.time() - t0):.2f} it/s)", flush=True)
    pose = jnp.asarray(ds.poses[int(ds.i_split[2][0])][:3])
    mean_rgb = {}
    for pid in (0, 1):
        tex = encode_texture(state.params, spec, uvs[pid])
        cond = prepare_conditioning(state.params, spec, jnp.zeros(50),
                                    exp_code_for(state.params, 0), tex)
        o = render_frame(state.params, spec, cond, H, W, jnp.asarray(K), pose)
        rgb, acc = np.asarray(o["rgb"]), np.asarray(o["acc"])
        mean_rgb[pid] = _scenes.mean_rgb(rgb, acc)
        imageio.imwrite(f"{out}/tex{pid}.png", (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    with open(f"{out}/texture_synthetic.json", "w") as f:
        json.dump({"mean_rgb_uv0": mean_rgb[0].tolist(), "mean_rgb_uv1": mean_rgb[1].tolist()},
                  f)
    print("render with uv0 (red): mean object RGB", mean_rgb[0].round(3))
    print("render with uv1 (blue): mean object RGB", mean_rgb[1].round(3))
    assert mean_rgb[0][0] > mean_rgb[0][2], "uv0 render not red-dominant"
    assert mean_rgb[1][2] > mean_rgb[1][0], "uv1 render not blue-dominant"
    print("TEXTURE CONTROL OK")


def train(ds, K, dev, steps: int, state, gen, keep=None):
    """`steps` train_steps of the study's teacher from `state` on the study's
    batches, the random numbers drawn from `gen` (on its device) and copied to
    `dev`; keep(i, state, batch, draws) is called before step i. Returns
    (state, every step's loss)."""
    spec, tx = _scenes.teacher_spec(), make_optimizer(lrate=LRATE)
    batch = texture_synthetic.batches(ds, K, dev)
    losses = []
    for i in range(steps):
        b = batch(i)
        draws = train_draws(gen, spec, _scenes.N_RAND, dev)
        if keep is not None:
            keep(i, state, b, draws)
        state, m = train_step(state, b, None, spec, tx, draws=draws)
        losses.append(m["loss"])
    return state, [float(v) for v in torch.stack(losses).cpu()]


def _data(out: str, dev):
    data = os.path.join(out, "data")
    os.makedirs(data, exist_ok=True)
    texture_synthetic.render_colored_cubes(data, 64, dev)
    ds, _, _, K = _scenes.load_dataset(data, [0, 1])
    return ds, K


def _seed0(dev):
    return create_train_state(torch.Generator().manual_seed(0), _scenes.teacher_spec(),
                              lrate=LRATE, device=dev)


def track(argv) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--devices", nargs="+", default=["cuda", "cpu"])
    args = p.parse_args(argv)
    ds, K = _data(args.out, _scenes.resolve_device(args.devices[0]))
    tracks, secs = [], []
    for d in args.devices:
        dev = _scenes.resolve_device(d)
        t0 = time.perf_counter()
        tracks.append(train(ds, K, dev, args.steps, _seed0(dev),
                            torch.Generator().manual_seed(0))[1])
        secs.append(time.perf_counter() - t0)
    ref = np.asarray(tracks[-1])
    departure = []
    for t in tracks:
        rel = np.abs(np.asarray(t) - ref) / np.maximum(np.abs(ref), 1e-12)
        departure.append({str(n): float(rel[:n].max()) for n in (10, 50, 100, args.steps)})
    result = {"devices": args.devices, "steps": args.steps, "secs": secs,
              "card": _scenes.device_name(torch.device("cuda")) if "cuda" in args.devices[0]
              else "cpu", "max_rel_departure_from_last": departure, "losses": tracks}
    print("[TRACK] " + json.dumps(result), flush=True)
    with open(os.path.join(args.out, "track.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def grads(argv) -> dict:
    from mofanerf_tpu_torch.train.state import batch_grads
    from mofanerf_tpu_torch.utils.tree import flatten_with_keystr

    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--every", type=int, default=100)
    p.add_argument("--devices", nargs=2, default=["cuda", "cpu"],
                   help="the device that trains, and the one it is compared with")
    args = p.parse_args(argv)
    dev = _scenes.resolve_device(args.devices[0])
    ds, K = _data(args.out, dev)
    spec, kept = _scenes.teacher_spec(), []

    def keep(i, state, batch, draws):
        if i % args.every == 0:
            kept.append((i, _to(state.params, "cpu"), _to(batch, "cpu"), _to(draws, "cpu")))
    _, losses = train(ds, K, dev, args.steps, _seed0(dev),
                      torch.Generator(device=dev).manual_seed(0), keep)
    rows = []
    for i, params, batch, draws in kept:
        out = {}
        for d in args.devices:
            loss, _, g = batch_grads(_to(params, d), _to(batch, d), None, spec, _to(draws, d))
            out[d] = (float(loss), [t.detach().double().cpu() for t in g])
        (lc, gc), (lp, gp) = out[args.devices[0]], out[args.devices[1]]
        diff = torch.cat([(a - b).reshape(-1) for a, b in zip(gc, gp)])
        ref = torch.cat([b.reshape(-1) for b in gp])
        leaf_rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    for a, b in zip(gc, gp)]
        names = [k for k, _ in flatten_with_keystr(params)]
        worst = int(np.argmax(leaf_rel))
        rows.append({"step": i, "loss": [lc, lp], "loss_rel": abs(lc - lp) / abs(lp),
                     "grad_rel_l2": float(diff.norm() / ref.norm().clamp_min(1e-30)),
                     "worst_leaf": names[worst], "worst_leaf_rel_max": leaf_rel[worst]})
    result = {"steps": args.steps, "every": args.every, "devices": args.devices,
              "card": _scenes.device_name(dev), "checks": rows, "losses": losses}
    print("[GRADS] " + json.dumps({k: v for k, v in result.items() if k != "losses"}), flush=True)
    with open(os.path.join(args.out, "grads.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    {"runs": runs, "one": one, "jax": jax_runs, "jax-one": jax_one, "track": track,
     "grads": grads}[sys.argv[1]](sys.argv[2:])
