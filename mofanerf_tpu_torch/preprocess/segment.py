"""Face parsing: BiSeNet (ResNet18 backbone) as torch modules, inference only.

The port of mofanerf_tpu/preprocess/segment.py. Capability parity with
tools/fit_data_pre/SegmentCode/model.py:231-263 + resnet.py:58-90: the
reference's modified BiSeNet (spatial path replaced by the backbone's 1/8
feature, attention refinement on 1/16 and 1/32, feature fusion, 19 classes)
plus the parse map -> mask heuristics of get_pair_parsing2.py:21-200.

BatchNorms are folded into a per-conv (scale, shift) at weight conversion
(`convert_bisenet_weights`), as in the JAX package. Parameters carry the
flax variables' names (`cp.resnet.stem.conv.weight` is flax's
`cp/resnet/stem/conv/kernel`, OIHW for HWIO; `...bn_scale` is `bn_scale`),
which is what `bridge.bisenet_params_to_torch` relies on. The nearest
upsampling between the context path's levels is jax.image.resize's: output
index i reads input floor((i + 0.5) * n_in / n_out), computed in float32.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mofanerf_tpu_torch.preprocess.bn_fold import fold_bn
from mofanerf_tpu_torch.utils.device import f32_products, resolve_device

N_CLASSES = 19


class ConvBN(nn.Module):
    """Conv (no bias) + folded-BN affine + optional relu."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(cout))
        self.bn_shift = nn.Parameter(torch.zeros(cout))
        self.relu = relu

    def forward(self, x):
        x = self.conv(x) * self.bn_scale[:, None, None] + self.bn_shift[:, None, None]
        return F.relu(x) if self.relu else x


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, stride=stride)
        self.conv2 = ConvBN(cout, cout, relu=False)
        self.downsample = (ConvBN(cin, cout, 1, stride, 0, relu=False)
                           if cin != cout or stride != 1 else None)

    def forward(self, x):
        r = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + r)


class Resnet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 64, 7, 2, 3)
        for layer, (cin, cout) in enumerate(((64, 64), (64, 128), (128, 256), (256, 512)), 1):
            stride = 1 if layer == 1 else 2
            setattr(self, f"layer{layer}_0", BasicBlock(cin, cout, stride))
            setattr(self, f"layer{layer}_1", BasicBlock(cout, cout))

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        x = self.layer1_1(self.layer1_0(x))
        feat8 = self.layer2_1(self.layer2_0(x))
        feat16 = self.layer3_1(self.layer3_0(feat8))
        feat32 = self.layer4_1(self.layer4_0(feat16))
        return feat8, feat16, feat32


class AttentionRefinement(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvBN(cin, cout)
        self.conv_atten = nn.Conv2d(cout, cout, 1, bias=False)
        self.bn_atten_scale = nn.Parameter(torch.ones(cout))
        self.bn_atten_shift = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        feat = self.conv(x)
        atten = self.conv_atten(feat.mean(dim=(2, 3), keepdim=True))
        atten = torch.sigmoid(atten * self.bn_atten_scale[:, None, None]
                              + self.bn_atten_shift[:, None, None])
        return feat * atten


def resize_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """[B, C, h, w] -> [B, C, H, W] as `jax.image.resize(..., "nearest")`:
    output index i reads floor((i + 0.5) * n_in / n_out), in float32."""
    for dim, n_out in zip((2, 3), hw):
        n_in = x.shape[dim]
        if n_in != n_out:
            pos = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * n_in / n_out
            x = x.index_select(dim, pos.floor().long())
    return x


def bilinear_align_corners(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B, C, h, w] -> [B, C, H, W] bilinear with align_corners=True (the
    reference upsamples its logits this way, SegmentCode/model.py:253-255)."""
    return F.interpolate(x, (H, W), mode="bilinear", align_corners=True)


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.conv_avg = ConvBN(512, 128, 1, 1, 0)
        self.arm32 = AttentionRefinement(512, 128)
        self.conv_head32 = ConvBN(128, 128)
        self.arm16 = AttentionRefinement(256, 128)
        self.conv_head16 = ConvBN(128, 128)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        f32 = self.arm32(feat32) + avg
        f32_up = self.conv_head32(resize_nearest(f32, feat16.shape[2:]))
        f16 = self.arm16(feat16) + f32_up
        f16_up = self.conv_head16(resize_nearest(f16, feat8.shape[2:]))
        return feat8, f16_up, f32_up


class FeatureFusion(nn.Module):
    def __init__(self, cin: int = 256, cout: int = 256):
        super().__init__()
        self.convblk = ConvBN(cin, cout, 1, 1, 0)
        self.conv1 = nn.Conv2d(cout, cout // 4, 1, bias=False)
        self.conv2 = nn.Conv2d(cout // 4, cout, 1, bias=False)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = F.relu(self.conv1(feat.mean(dim=(2, 3), keepdim=True)))
        atten = torch.sigmoid(self.conv2(atten))
        return feat * atten + feat


class Output(nn.Module):
    def __init__(self, cin: int, mid: int, n_classes: int = N_CLASSES):
        super().__init__()
        self.conv = ConvBN(cin, mid)
        self.conv_out = nn.Conv2d(mid, n_classes, 1, bias=False)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    def __init__(self, n_classes: int = N_CLASSES):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusion(256, 256)
        self.conv_out = Output(256, 256, n_classes)

    def forward(self, x):
        """x: [B, 3, H, W] normalized -> [B, n_classes, H, W] logits."""
        H, W = x.shape[2:]
        feat8, fcp8, _ = self.cp(x)
        out = self.conv_out(self.ffm(feat8, fcp8))
        return bilinear_align_corners(out, H, W)


def load_bisenet(state: Dict[str, torch.Tensor]) -> BiSeNet:
    """A BiSeNet in eval mode holding `state` (the port's parameters, as
    `convert_bisenet_weights` or `bridge.bisenet_params_to_torch` give
    them), on the state's device."""
    dev = next(iter(state.values())).device
    with torch.device("meta"):
        net = BiSeNet()
    net.load_state_dict(state, assign=True)
    return net.to(dev).eval().requires_grad_(False)


# ImageNet normalization used by the reference's evaluate()
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def segment_logits(img: torch.Tensor, net: BiSeNet) -> torch.Tensor:
    """img: float [H, W, 3] in [0, 1] on the net's device -> [19, H, W]
    logits, the convolutions in full f32 (TF32 off)."""
    mean = torch.from_numpy(_MEAN).to(img.device)
    std = torch.from_numpy(_STD).to(img.device)
    x = ((img.float() - mean) / std).permute(2, 0, 1)[None]
    with torch.no_grad(), f32_products():
        return net(x)[0]


def segment_face(img, net) -> np.ndarray:
    """img: [H, W, 3] float [0,1] (numpy, or a tensor) -> parse map [H, W]
    int (19 classes). `net` is a BiSeNet or its state dict; the work runs
    on its device."""
    if not isinstance(net, nn.Module):
        net = load_bisenet(net)
    dev = next(net.parameters()).device
    x = torch.as_tensor(img).to(dev)
    return segment_logits(x, net).argmax(0).cpu().numpy()


# Parse-map classes to KEEP for the face region (the reference zeroes
# background/clothes/necklace and rows >= 450 —
# tools/wildData_preprocess.py:98-117). Class ids follow face-parsing.PyTorch:
# 0=bg, 14=neck, 16=clothes, 18=hat; hair (17) is kept by the reference.
_DROP_CLASSES = (0, 14, 16, 18)


def face_mask_from_parsing(parse: np.ndarray, row_cut: int = 450) -> np.ndarray:
    """[H, W] parse map -> binary face mask with the reference's removal
    heuristics."""
    mask = ~np.isin(parse, _DROP_CLASSES)
    mask[row_cut:, :] = False
    return mask.astype(np.uint8)


def _convbn(sd, conv_key, bn_key, name):
    scale, shift = fold_bn(sd, bn_key)
    return {f"{name}.conv.weight": np.asarray(sd[f"{conv_key}.weight"]),
            f"{name}.bn_scale": scale, f"{name}.bn_shift": shift}


def convert_bisenet_weights(state_dict: Dict[str, Any], device="cuda") -> Dict[str, torch.Tensor]:
    """Reference Seg_79999_iter.pth state dict -> the port's BiSeNet
    parameters on `device` (BatchNorms folded), checked against the
    module's shapes."""
    dev = resolve_device(device)
    sd = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
          for k, v in state_dict.items()}
    p: Dict[str, np.ndarray] = {}
    p.update(_convbn(sd, "cp.resnet.conv1", "cp.resnet.bn1", "cp.resnet.stem"))
    for layer in range(1, 5):
        for i in range(2):
            src, dst = f"cp.resnet.layer{layer}.{i}", f"cp.resnet.layer{layer}_{i}"
            p.update(_convbn(sd, f"{src}.conv1", f"{src}.bn1", f"{dst}.conv1"))
            p.update(_convbn(sd, f"{src}.conv2", f"{src}.bn2", f"{dst}.conv2"))
            if f"{src}.downsample.0.weight" in sd:
                p.update(_convbn(sd, f"{src}.downsample.0", f"{src}.downsample.1",
                                 f"{dst}.downsample"))
    for arm in ("cp.arm16", "cp.arm32"):
        p.update(_convbn(sd, f"{arm}.conv.conv", f"{arm}.conv.bn", f"{arm}.conv"))
        p[f"{arm}.conv_atten.weight"] = sd[f"{arm}.conv_atten.weight"]
        p[f"{arm}.bn_atten_scale"], p[f"{arm}.bn_atten_shift"] = fold_bn(sd, f"{arm}.bn_atten")
    for name in ("cp.conv_head32", "cp.conv_head16", "cp.conv_avg", "ffm.convblk",
                 "conv_out.conv"):
        p.update(_convbn(sd, f"{name}.conv", f"{name}.bn", name))
    for name in ("ffm.conv1", "ffm.conv2", "conv_out.conv_out"):
        p[f"{name}.weight"] = sd[f"{name}.weight"]
    return state_to_device(p, BiSeNet, dev)


def state_to_device(p: Dict[str, np.ndarray], module_cls, dev) -> Dict[str, torch.Tensor]:
    """numpy parameters -> f32 tensors on `dev`, checked key for key and
    shape for shape against `module_cls()`'s state dict."""
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in module_cls().state_dict().items()}
    got = {k: tuple(np.shape(v)) for k, v in p.items()}
    if got != want:
        diff = sorted(set(got) ^ set(want)) or [k for k in want if got[k] != want[k]]
        raise ValueError(f"{module_cls.__name__} parameters do not match its layout: {diff[:8]}")
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev) for k, v in p.items()}
