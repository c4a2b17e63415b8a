"""Portrait relighting: DPR-style Hourglass network as torch modules.

The port of mofanerf_tpu/preprocess/relight.py. Capability parity with
tools/fit_data_pre/models/defineHourglass_512_gray_skip.py (:20-195) +
RelightingModule.py:22-55: 4 nested hourglass blocks whose innermost
`lightingNet` (a) predicts the source lighting as 9 SH coefficients from the
mean of the 27 lighting channels and (b) REPLACES those channels with
features derived from a target SH, relighting the image to the canonical
FaceScape studio light. Runs on the L channel of 8-bit Lab at 512x512.

Inference only: BatchNorms folded at conversion; the skip branches'
instance norms (parameter-free in the reference) run at eps 1e-5 with the
population variance (`models/refine/generator.py::InstanceNorm`).
Parameters carry the flax variables' names (`HG3_low1.bn1_scale`,
`light.predict_FC1.weight`, ...), which `bridge.hourglass_params_to_torch`
relies on.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mofanerf_tpu_torch.models.refine.generator import InstanceNorm
from mofanerf_tpu_torch.preprocess.bn_fold import fold_bn
from mofanerf_tpu_torch.preprocess.segment import state_to_device
from mofanerf_tpu_torch.utils.device import f32_products, resolve_device
from mofanerf_tpu_torch.utils.image_io import lab_to_rgb_u8, resize_linear, rgb_to_lab_u8

NC_LIGHT = 27
NC_OUT_LIGHT = 9


def _affine(x, scale, shift):
    return x * scale[:, None, None] + shift[:, None, None]


class BasicBlock(nn.Module):
    """conv-norm-relu-conv-norm + 1x1 shortcut when channels change.

    norm_type: 'bn' (folded affine) or 'in' (runtime instance norm)."""

    def __init__(self, cin: int, cout: int, norm_type: str = "bn"):
        super().__init__()
        self.norm_type = norm_type
        self.conv1 = nn.Conv2d(cin, cout, 3, 1, 1, bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        if norm_type == "bn":
            self.bn1_scale = nn.Parameter(torch.ones(cout))
            self.bn1_shift = nn.Parameter(torch.zeros(cout))
            self.bn2_scale = nn.Parameter(torch.ones(cout))
            self.bn2_shift = nn.Parameter(torch.zeros(cout))
        else:
            self.norm = InstanceNorm()
        self.shortcut = nn.Conv2d(cin, cout, 1, bias=False) if cin != cout else None

    def _norm(self, x, idx):
        if self.norm_type == "in":
            return self.norm(x)
        return _affine(x, getattr(self, f"bn{idx}_scale"), getattr(self, f"bn{idx}_shift"))

    def forward(self, x):
        out = F.relu(self._norm(self.conv1(x), 1))
        out = self._norm(self.conv2(out), 2)
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(out + x)


def _prelu(x, a):
    return torch.where(x >= 0, x, a * x)


class LightingNet(nn.Module):
    """Innermost block: predict source SH from the lighting channels and
    substitute target-SH features back (defineHourglass...:100-139)."""

    def __init__(self, nc_middle: int = 128):
        super().__init__()
        self.predict_FC1 = nn.Conv2d(NC_LIGHT, nc_middle, 1, bias=False)
        self.predict_prelu = nn.Parameter(torch.full((1,), 0.25))
        self.predict_FC2 = nn.Conv2d(nc_middle, NC_OUT_LIGHT, 1, bias=False)
        self.post_FC1 = nn.Conv2d(NC_OUT_LIGHT, nc_middle, 1, bias=False)
        self.post_prelu = nn.Parameter(torch.full((1,), 0.25))
        self.post_FC2 = nn.Conv2d(nc_middle, NC_LIGHT, 1, bias=False)

    def forward(self, inner_feat, target_light):
        x = inner_feat[:, :NC_LIGHT]
        feat = x.mean(dim=(2, 3), keepdim=True)
        light = self.predict_FC2(_prelu(self.predict_FC1(feat), self.predict_prelu))
        up = _prelu(self.post_FC1(target_light), self.post_prelu)
        up = F.relu(self.post_FC2(up)).expand(-1, -1, x.shape[2], x.shape[3])
        return torch.cat([up, inner_feat[:, NC_LIGHT:]], dim=1), light


class HourglassNet(nn.Module):
    """4-level hourglass; returns (relit L channel [B,1,H,W] in [0,1],
    predicted source SH [B,9,1,1]). `skip_count` is static: levels
    shallower than it drop the skip branch (defineHourglass...:88-95)."""

    def __init__(self, base: int = 16, skip_count: int = 0):
        super().__init__()
        self.skip_count = skip_count
        nc_pre = base
        ncs = [base, 2 * base, 4 * base, 8 * base + NC_LIGHT]
        self.pre_conv = nn.Conv2d(1, nc_pre, 5, 1, 2)
        self.pre_bn_scale = nn.Parameter(torch.ones(nc_pre))
        self.pre_bn_shift = nn.Parameter(torch.zeros(nc_pre))
        for level in (3, 2, 1, 0):
            idx = 3 - level
            inp = nc_pre if level == 3 else ncs[idx - 1]
            setattr(self, f"HG{level}_upper", BasicBlock(inp, inp, "in"))
            setattr(self, f"HG{level}_low1", BasicBlock(inp, ncs[idx], "bn"))
            setattr(self, f"HG{level}_low2", BasicBlock(ncs[idx], inp, "in"))
        self.light = LightingNet()
        for i in (1, 2, 3):
            k = 3 if i == 1 else 1
            setattr(self, f"conv_{i}", nn.Conv2d(nc_pre, nc_pre, k, 1, k // 2))
            setattr(self, f"bn_{i}_scale", nn.Parameter(torch.ones(nc_pre)))
            setattr(self, f"bn_{i}_shift", nn.Parameter(torch.zeros(nc_pre)))
        self.output = nn.Conv2d(nc_pre, 1, 1)

    def _hourglass(self, h, level, count, target_light):
        upper = getattr(self, f"HG{level}_upper")(h)
        low = getattr(self, f"HG{level}_low1")(F.max_pool2d(h, 2, 2))
        if level == 0:
            low, light = self.light(low, target_light)
        else:
            low, light = self._hourglass(low, level - 1, count + 1, target_light)
        low = getattr(self, f"HG{level}_low2")(low)
        low = F.interpolate(low, scale_factor=2, mode="nearest")   # exact 2x: JAX's too
        return (low + upper if count >= self.skip_count else low), light

    def forward(self, x, target_light):
        feat = F.relu(_affine(self.pre_conv(x), self.pre_bn_scale, self.pre_bn_shift))
        feat, out_light = self._hourglass(feat, 3, 0, target_light)
        for i in (1, 2, 3):
            feat = getattr(self, f"conv_{i}")(feat)
            feat = F.relu(_affine(feat, getattr(self, f"bn_{i}_scale"),
                                  getattr(self, f"bn_{i}_shift")))
        return torch.sigmoid(self.output(feat)), out_light


def load_hourglass(state: Dict[str, torch.Tensor], skip_count: int = 0) -> HourglassNet:
    """A HourglassNet in eval mode holding `state`, on the state's device."""
    dev = next(iter(state.values())).device
    with torch.device("meta"):
        net = HourglassNet(skip_count=skip_count)
    net.load_state_dict(state, assign=True)
    return net.to(dev).eval().requires_grad_(False)


def relight_to_canonical(img_rgb, net, target_sh: np.ndarray, size: int = 512):
    """Relight an RGB [0,1] image (numpy or a tensor) to the canonical studio
    SH (RelightingModule.trans_get_sh behavior): run the net on the 8-bit Lab
    L channel, merge the relit L back. `net` is a HourglassNet or its state
    dict; the work runs on its device, the convolutions in full f32 (TF32
    off). Returns (relit rgb [H, W, 3] float32 tensor on that device, source
    SH [9] numpy)."""
    if not isinstance(net, nn.Module):
        net = load_hourglass(net)
    dev = next(net.parameters()).device
    img = torch.as_tensor(img_rgb).to(dev)
    h0, w0 = img.shape[:2]
    if (h0, w0) != (size, size):   # cv2.resize at its default INTER_LINEAR, on the host
        img = torch.from_numpy(resize_linear(img.cpu().numpy(), (size, size))).to(dev)
    lab = rgb_to_lab_u8((img * 255).to(torch.uint8))   # truncation, as astype(uint8)
    L = lab[..., 0].float() / 255.0
    tl = torch.as_tensor(np.asarray(target_sh, np.float32).reshape(1, 9, 1, 1)).to(dev)
    with torch.no_grad(), f32_products():
        out_l, src_light = net(L[None, None], tl)
    relit_l = out_l[0, 0]
    lab = torch.cat([(relit_l * 255).clamp(0, 255).to(torch.uint8)[..., None], lab[..., 1:]], -1)
    relit = lab_to_rgb_u8(lab).float() / 255.0
    if (h0, w0) != (size, size):
        relit = torch.from_numpy(resize_linear(relit.cpu().numpy(), (w0, h0))).to(dev)
    return relit, src_light.reshape(9).cpu().numpy()


def convert_hourglass_weights(state_dict: Dict[str, Any], device="cuda") -> Dict[str, torch.Tensor]:
    """Reference trained_model_03.t7 state dict -> the port's HourglassNet
    parameters on `device` (BatchNorms folded)."""
    dev = resolve_device(device)
    sd = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
          for k, v in state_dict.items()}
    p: Dict[str, np.ndarray] = {"pre_conv.weight": sd["pre_conv.weight"],
                                "pre_conv.bias": sd["pre_conv.bias"]}
    p["pre_bn_scale"], p["pre_bn_shift"] = fold_bn(sd, "pre_bn")

    def basic(src, dst, bn):
        p[f"{dst}.conv1.weight"] = sd[f"{src}.conv1.weight"]
        p[f"{dst}.conv2.weight"] = sd[f"{src}.conv2.weight"]
        if bn:
            p[f"{dst}.bn1_scale"], p[f"{dst}.bn1_shift"] = fold_bn(sd, f"{src}.bn1")
            p[f"{dst}.bn2_scale"], p[f"{dst}.bn2_shift"] = fold_bn(sd, f"{src}.bn2")
        # the reference registers `shortcuts` unconditionally but applies it only
        # when the block changes the channel count (defineHourglass_512_gray_skip.py:37,64-67)
        w1 = sd[f"{src}.conv1.weight"]
        if w1.shape[0] != w1.shape[1] and f"{src}.shortcuts.weight" in sd:
            p[f"{dst}.shortcut.weight"] = sd[f"{src}.shortcuts.weight"]

    path = {3: "HG3", 2: "HG3.middle", 1: "HG3.middle.middle", 0: "HG3.middle.middle.middle"}
    for level, pref in path.items():
        basic(f"{pref}.upper", f"HG{level}_upper", False)
        basic(f"{pref}.low1", f"HG{level}_low1", True)
        basic(f"{pref}.low2", f"HG{level}_low2", False)
    lp = f"{path[0]}.middle"
    for name in ("predict_FC1", "predict_FC2", "post_FC1", "post_FC2"):
        p[f"light.{name}.weight"] = sd[f"{lp}.{name}.weight"]
    p["light.predict_prelu"] = sd[f"{lp}.predict_relu1.weight"].reshape(1)
    p["light.post_prelu"] = sd[f"{lp}.post_relu1.weight"].reshape(1)
    for i in (1, 2, 3):
        p[f"conv_{i}.weight"], p[f"conv_{i}.bias"] = sd[f"conv_{i}.weight"], sd[f"conv_{i}.bias"]
        p[f"bn_{i}_scale"], p[f"bn_{i}_shift"] = fold_bn(sd, f"bn_{i}")
    p["output.weight"], p["output.bias"] = sd["output.weight"], sd["output.bias"]
    return state_to_device(p, HourglassNet, dev)
