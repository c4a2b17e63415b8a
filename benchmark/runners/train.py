"""Training on the device-resident split: `train/loop.py::train_chunk_device_data`
(batches drawn on the card by `data/device_data.py::sample_batch_device`,
`train/state.py::train_step` a step) in chunks of `scan_steps`.

Set-up writes the split (`splitwrite.py`), reads it through the program's
loader onto the card, makes the weights, and drives the first steps through
the window's own call in the chunks of `check_chunks`: they warm the shapes
up, and they are what the comparison reads. The first chunk is one step
(Adam's state after it gives the first gradient); one chunk of several steps
ends on step 3 (the weights after it give the change over three steps, so a
chunk of many steps is compared); each later chunk of one step gives that
step's loss. The reference takes the first step from the same weights and
draws; for each step run alone, the loss of that step's batch at the
weights the program held before it (the program's own state: the reference
follows it step by step); and three steps on its own, whose change of each
weight is compared with the program's. The window then runs chunks of
`scan_steps` from the step after them."""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark.common import rng, sub_seed
from benchmark.counts import train_step_flops
from benchmark.runners.teacher_model import (make_params, program_config, sync,
                                             tree_items)
from benchmark.reference import train as ref_train
from benchmark.reference.precision import Precision, full_f32
from benchmark.splitwrite import write_split
from mofanerf_tpu_torch.data.device_data import DeviceSamplerConfig, build_device_dataset
from mofanerf_tpu_torch.data.facescape import load_facescape_data, valid_persons
from mofanerf_tpu_torch.train.loop import train_chunk_device_data
from mofanerf_tpu_torch.train.state import TrainState, make_optimizer

B1 = 0.9   # Adam's first-moment decay, the program's and the reference's


class Runner:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, workdir: str):
        self.cfg, self.traffic, self.dev = cfg, traffic, torch.device(device)
        root = os.path.join(workdir, "split")
        self.marks = []
        self.split = write_split(root, rng(seed, 10), traffic["identities"],
                                 traffic["expressions"], traffic["views"], traffic["size"],
                                 traffic["camera"]["focal"], traffic["camera"], cfg["uv_size"],
                                 cfg["input_ch_shapeCodes"])
        self.marks.append(("split written", time.perf_counter()))
        pcfg = program_config(cfg, white_bkgd=traffic["white_bkgd"], device_data=True,
                              i_grid=traffic["i_grid"], scan_steps=traffic["scan_steps"])
        self.spec = spec = pcfg.model_spec()
        ds = load_facescape_data(root, valid_persons(root), self.split["shape_codes"])
        ds.uv_paths = self.split["uv_paths"]
        self.marks.append(("split read", time.perf_counter()))
        H, W, focal = ds.hwf
        self.K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)
        self.prog_seed = sub_seed(seed, 11, bits=28)
        self.dd, bias = build_device_dataset(ds, self.K, ds.i_split[0],
                                             landmarks=self.split["landmarks"],
                                             uv_size=spec.uv_size,
                                             white_bkgd=traffic["white_bkgd"],
                                             seed=self.prog_seed, device=self.dev)
        self.scfg = DeviceSamplerConfig(
            n_rand=pcfg.N_rand, H=H, W=W, precrop_iters=pcfg.precrop_iters,
            precrop_frac=pcfg.precrop_frac, lm_frac=pcfg.lm_frac,
            lm_frac_anneal_iters=pcfg.lm_frac_anneal_iters, bias=bias)
        self.Kt = torch.from_numpy(self.K).to(self.dev)
        self.marks.append(("split on the card", time.perf_counter()))
        self.tx = make_optimizer(pcfg.lrate, pcfg.lrate_decay)
        params = make_params(spec, seed, self.dev)
        state = TrainState(params, self.tx.init(params),
                           torch.zeros((), dtype=torch.int32, device=self.dev))
        self.p0, self.i0, self.tree = params, traffic["first_step"], params
        self.losses, self.psnr, self.after, k = {}, {}, {}, 0
        for n in traffic["check_chunks"]:
            state, m = self._chunk(state, self.i0 + k, n)
            self.losses[k + n - 1], self.psnr[k + n - 1] = m["loss"], m["psnr"]
            k += n
            self.after[k] = state.params
            if k == 1:
                self.mu1 = state.opt_state.mu
        if 1 not in self.after or 3 not in self.after:
            raise ValueError("check_chunks has to start with a chunk of one step and end a "
                             "chunk on step 3")
        self.state, self.i, self.steps = state, self.i0 + k, 0
        self.n_rand = pcfg.N_rand
        sync(self.dev)

    def _chunk(self, state, i, n):
        return train_chunk_device_data(state, self.dd, self.Kt, i, n, self.scfg, self.spec,
                                       self.tx, self.prog_seed)

    # --- the window ------------------------------------------------------------------

    def unit(self, tracing: bool = False) -> None:
        n = self.traffic["trace_steps"] if tracing else self.traffic["scan_steps"]
        self.state, _ = self._chunk(self.state, self.i, n)
        self.i += n
        self.steps += n

    def sync(self) -> None:
        sync(self.dev)

    def begin(self) -> None:
        self.steps = 0

    def end_to_end(self, seconds: float) -> dict:
        return {"train_rays_per_s": self.steps * self.n_rand / seconds}

    def layer_info(self) -> dict:
        fields, enc = train_step_flops(self.cfg)
        return {"steps": self.steps, "step_flops": fields + enc}

    # --- the comparison --------------------------------------------------------------

    def collect(self) -> dict:
        """What the program produced that the comparison reads; the
        program's state is let go."""
        sample = {"losses": {k: float(x) for k, x in self.losses.items()},
                  "fine": {k: 10.0 ** (-float(x) / 10.0) for k, x in self.psnr.items()},
                  "grad1": {p: v / (1 - B1) for p, v in tree_items(self.mu1)},
                  "p0": dict(tree_items(self.p0)),
                  "after": {k: dict(tree_items(p)) for k, p in self.after.items()}}
        del self.state, self.dd, self.mu1, self.after
        return sample

    def _ref_data(self) -> dict:
        s, dev = self.split, self.dev
        lm2d = np.stack([ref_train.project_landmarks(s["landmarks"][i, e], self.K, pose)
                         for i, e, pose in zip(s["ids"], s["exp_types"], s["poses"])])
        t = lambda a, dt=None: torch.as_tensor(a, device=dev, dtype=dt)  # noqa: E731
        return {"images": t(s["images"]), "poses": t(s["poses"]), "K": t(self.K),
                "lm2d": t(lm2d), "shape_codes": t(s["shape_codes"][s["ids"]]),
                "exp_types": s["exp_types"], "uv_index": s["ids"],
                "uv_maps": t(s["uv_maps"], torch.float32) / 255.0,
                "H": s["images"].shape[1], "W": s["images"].shape[2]}

    def reference_steps(self, p0: dict, precision: Precision, n: int,
                        keep_share: float = 1.0) -> dict:
        """The reference's first `n` steps from the weights `p0` ({path:
        tensor}): each step's loss ({step: loss}, steps from 0), the first
        step's gradients, the weights after each step ({steps done: weights}).
        `keep_share` < 1 trains on that share of each batch's rays (a fault
        the comparison has to catch)."""
        cfg, data = self._ref_cfg(), self._ref_data()
        paths = list(p0)
        leaves = [p0[p].detach().clone().requires_grad_(True) for p in paths]
        mu = [torch.zeros_like(x) for x in leaves]
        nu = [torch.zeros_like(x) for x in leaves]
        keep = None if keep_share >= 1.0 else slice(0, int(self.n_rand * keep_share))
        losses, fine, grad1, after = {}, {}, None, {}
        with full_f32():
            for k in range(n):
                b = ref_train.batch(data, cfg, self.prog_seed, self.i0 + k, self.dev)
                params = _tree(self.tree, dict(zip(paths, leaves)))
                loss, grads, fine_k = ref_train.loss_and_grads(params, leaves, data, cfg, b,
                                                               precision, keep)
                losses[k], fine[k] = float(loss), float(fine_k)
                if k == 0:
                    grad1 = dict(zip(paths, grads))
                new, mu, nu = ref_train.adam([x.detach() for x in leaves], grads, mu, nu, k, cfg)
                after[k + 1] = {p: x.detach() for p, x in zip(paths, new)}
                leaves = [x.requires_grad_(True) for x in new]
        return {"losses": losses, "fine": fine, "grad1": grad1, "after": after}

    def alone(self) -> list:
        """The steps (from 0) that set-up ran as chunks of one step."""
        out, k = [], 0
        for n in self.traffic["check_chunks"]:
            if n == 1:
                out.append(k)
            k += n
        return out

    def reference_losses(self, p0: dict, after: dict) -> dict:
        """The reference's loss and fine colour's mean square error (f32) of
        each step run alone's batch at the weights that side held before it:
        `p0` before step 0, `after[k]` before step k."""
        cfg, data = self._ref_cfg(), self._ref_data()
        out = {}
        with torch.no_grad(), full_f32():
            for k in self.alone():
                weights = after[k] if k else p0
                b = ref_train.batch(data, cfg, self.prog_seed, self.i0 + k, self.dev)
                params = _tree(self.tree, {p: v.float() for p, v in weights.items()})
                loss, _, fine = ref_train.loss_and_grads(params, None, data, cfg, b,
                                                         Precision("f32"))
                out[k] = (float(loss), float(fine))
        return out

    def _ref_cfg(self) -> dict:
        return dict(self.cfg, white_bkgd=self.traffic["white_bkgd"])

    def numbers(self, sample: dict, candidate) -> dict:
        """The comparison's numbers of `candidate` against the reference in
        f32: 'program' (what the window's path produced), or a reference run
        of its own (a Precision, or ('keep', share): a share of the rays)."""
        n = sum(self.traffic["check_chunks"])
        if not hasattr(self, "_ref"):
            self._ref = self.reference_steps(sample["p0"], Precision("f32"), 3)
        if candidate == "program":
            got = sample
        elif isinstance(candidate, Precision):
            got = self.reference_steps(sample["p0"], candidate, n)
        else:
            got = self.reference_steps(sample["p0"], Precision("f32"), n, keep_share=candidate[1])
        forced = self.reference_losses(sample["p0"], got["after"])
        return gaps(sample["p0"], self._ref, got, forced)

    def release_reference(self) -> None:
        self.__dict__.pop("_ref", None)


def _tree(like, values: dict, prefix: str = ""):
    """`like`'s nested dicts and lists holding values[path] at each leaf's path."""
    if isinstance(like, dict):
        return {k: _tree(v, values, f"{prefix}/{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_tree(v, values, f"{prefix}/{i}") for i, v in enumerate(like)]
    return values[prefix]


def gaps(p0: dict, ref: dict, got: dict, forced: list) -> dict:
    """The comparison's numbers. loss_gap: over the steps run alone
    (`forced`: {step: (loss, fine colour's error)}), the median of the
    relative gaps between a step's loss and the reference's loss of the same
    batch at the weights that side held before the step (the largest,
    loss_max_gap, swings with the fine samples of one step). Per leaf, the
    relative gap between the norms of the two sides' change of the weights
    over the first three steps, each side on its own (a leaf's gap over the
    larger of its reference norm and the median leaf's): change_gap, the
    median over the leaves that move at least as far as the median leaf
    (those that move less carry the noise of Adam's first steps on small
    gradients); change_worst_gap, the largest over every leaf. Leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out. Beside them, for the look at a reading: the median over every leaf
    (change_all_gap), the same of the first gradients (grad_gap,
    grad_worst_gap), the fine and coarse colours' loss gaps, the first step's
    loss gap, the largest gap of the two sides' own losses over the first
    three steps, which leaf is worst, and each step's gaps."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    losses = [rel(got["losses"][k], b) for k, (b, _) in forced.items()]
    fines = [rel(got["fine"][k], f) for k, (_, f) in forced.items()]
    coarses = [rel(got["losses"][k] - got["fine"][k], b - f) for k, (b, f) in forced.items()]
    free = [rel(got["losses"][k], ref["losses"][k]) for k in range(3) if k in got["losses"]]
    paths = list(ref["grad1"])
    g_ref = np.array([float(ref["grad1"][p].norm()) for p in paths])
    live = g_ref >= 1e-3 * np.median(g_ref)
    paths = [p for p, k in zip(paths, live) if k]
    g_ref = g_ref[live]
    g_got = np.array([float(got["grad1"][p].float().norm()) for p in paths])
    d_ref = np.array([float((ref["after"][3][p] - p0[p]).norm()) for p in paths])
    d_got = np.array([float((got["after"][3][p].float() - p0[p]).norm()) for p in paths])

    def per_leaf(a, b):
        return np.abs(a - b) / np.maximum(b, np.median(b))

    g, d = per_leaf(g_got, g_ref), per_leaf(d_got, d_ref)
    moving = d_ref >= np.median(d_ref)
    out = {"loss_gap": float(np.median(losses)), "loss_max_gap": max(losses),
           "fine_loss_gap": max(fines), "coarse_loss_gap": max(coarses),
           "change_gap": float(np.median(d[moving])), "change_all_gap": float(np.median(d)),
           "change_worst_gap": float(d.max()), "grad_gap": float(np.median(g)),
           "grad_worst_gap": float(g.max()), "loss1_gap": losses[0], "free_loss_gap": max(free)}
    out = {k: (v if np.isfinite(v) else float("inf")) for k, v in out.items()}
    out["loss_gaps"] = [float(x) for x in losses]
    out["fine_gaps"] = [float(x) for x in fines]
    out["coarse_gaps"] = [float(x) for x in coarses]
    out["losses"] = [float(b) for b, _ in forced.values()]
    out["grad_gap_quartiles"] = [float(x) for x in np.quantile(g, [0.25, 0.5, 0.75, 0.9])]
    out["grad_worst_leaf"] = paths[int(np.argmax(g))]
    out["change_worst_leaf"] = paths[int(np.argmax(d))]
    return out
