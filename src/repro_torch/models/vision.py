"""Scaled-down versions of the paper's workloads (VGG / ResNet / YOLO / FCN)
for the scenario runs (paper Figs. 11-13): conv nets described as layer
lists, so each layer is one swap unit of ``SwappedSequential``.

The layer lists, shapes and init scales are the JAX package's
(``repro/models/vision.py``), scaled ~20x down from the paper's sizes but
keeping the structural traits the paper leans on: VGG's huge unbalanced
fc layer, ResNet's many thin layers, conv-only YOLO / FCN.

Layout: activations are NHWC and conv weights HWIO at every interface, as
in the JAX package, so store files stay byte-compatible. :func:`_conv`
views both in NCHW / OIHW (an NHWC tensor permuted is a ``channels_last``
NCHW one, no copy) and calls ``torch.nn.functional.conv2d``; the reference
convolves with XLA's ``conv_general_dilated``, not a Pallas kernel. Its
``"SAME"`` padding puts the odd pad at the HIGH end (at k 3, s 2 on an even
input: none before, one after), so the pads are applied explicitly and
the convolution runs unpadded. The fc layer goes through
:func:`repro_torch.models.layers.linear` (``swap_linear``, or
``swap_linear_q`` on a quantized-resident weight).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.qtensor import materialize
from repro_torch.models.layers import linear


@dataclass(frozen=True)
class Layer:
    kind: str                 # conv | res | pool | gap | fc
    cin: int = 0
    cout: int = 0
    k: int = 3
    stride: int = 1


def vgg_sim() -> Tuple[str, List[Layer], int]:
    """VGG-ish: conv stack + dominant fc (the paper's 'largest layer 392MB')."""
    chans = [(3, 32), (32, 64), (64, 128), (128, 128), (128, 256), (256, 256)]
    layers = []
    for i, (a, b) in enumerate(chans):
        layers.append(Layer("conv", a, b, 3, 1))
        if i % 2 == 1:
            layers.append(Layer("pool"))
    layers.append(Layer("gap"))
    layers += [Layer("fc", 256, 4096), Layer("fc", 4096, 1024),
               Layer("fc", 1024, 100)]
    return "vgg_sim", layers, 32


def resnet_sim(depth: int = 34) -> Tuple[str, List[Layer], int]:
    """ResNet-ish: many thin residual layers (hard to partition, paper §6.2)."""
    layers = [Layer("conv", 3, 32, 3, 1)]
    c = 32
    for stage, blocks in enumerate([3, 4, 6, 3][:max(2, depth // 10)]):
        for b in range(blocks):
            layers.append(Layer("res", c, c, 3, 1))
        if stage < 3:
            layers.append(Layer("conv", c, c * 2, 3, 2))
            c *= 2
    layers += [Layer("gap"), Layer("fc", c, 100)]
    return "resnet_sim", layers, 32


def yolo_sim() -> Tuple[str, List[Layer], int]:
    layers = [Layer("conv", 3, 32, 3, 1)]
    c = 32
    for _ in range(4):
        layers.append(Layer("conv", c, c * 2, 3, 2))
        layers.append(Layer("res", c * 2, c * 2, 3, 1))
        c *= 2
    layers.append(Layer("conv", c, 255, 1, 1))      # detection head
    return "yolo_sim", layers, 64


def fcn_sim() -> Tuple[str, List[Layer], int]:
    layers = []
    c = 3
    for nc in (32, 64, 128):
        layers.append(Layer("conv", c, nc, 3, 2))
        c = nc
    for nc in (128, 64):
        layers.append(Layer("conv", c, nc, 3, 1))
        c = nc
    layers.append(Layer("conv", c, 21, 1, 1))       # seg classes
    return "fcn_sim", layers, 64


MODELS: Dict[str, Callable] = {"vgg": vgg_sim, "resnet": resnet_sim,
                               "yolo": yolo_sim, "fcn": fcn_sim}


# ------------------------------------------------------------------ init/apply
def init_layer(l: Layer, g: torch.Generator, device=None) -> dict:
    """One layer's params (fp32), drawn from ``g`` on ``device`` (the
    generator's own by default): conv / res weights HWIO and fc weights
    [cin, cout] ~ N(0, 1) * fan_in ** -0.5, zero biases."""
    device = g.device if device is None else torch.device(device)
    if l.kind in ("conv", "res"):
        w = torch.randn((l.k, l.k, l.cin, l.cout), generator=g,
                        device=device) * (l.k * l.k * l.cin) ** -0.5
        return {"w": w, "b": torch.zeros((l.cout,), device=device)}
    if l.kind == "fc":
        w = torch.randn((l.cin, l.cout), generator=g,
                        device=device) * l.cin ** -0.5
        return {"w": w, "b": torch.zeros((l.cout,), device=device)}
    return {}


def init_convnet(layers: Sequence[Layer], g: torch.Generator,
                 device=None) -> List[dict]:
    """Params of every layer, drawn in order from ``g``. The random numbers
    differ from ``jax.random``'s; parity tests hand the JAX params over
    (``repro_torch.convert.params_from_jax``)."""
    return [init_layer(l, g, device) for l in layers]


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) pads of XLA's ``"SAME"`` on one spatial axis: the output
    is ceil(size / stride) and the odd pad goes at the high end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w, b: torch.Tensor, stride: int) -> torch.Tensor:
    """NHWC x HWIO -> NHWC, ``"SAME"`` padding. A quantized-resident weight
    dequantizes on the device at use (``dequant_int8``)."""
    w = materialize(w)
    k = w.shape[0]
    (hlo, hhi), (wlo, whi) = (same_pads(x.shape[1], k, stride),
                              same_pads(x.shape[2], k, stride))
    xc = x.permute(0, 3, 1, 2)                   # channels_last NCHW view
    if hlo or hhi or wlo or whi:
        xc = F.pad(xc, (wlo, whi, hlo, hhi))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + b


def apply_layer(l: Layer, p: dict, x: torch.Tensor) -> torch.Tensor:
    if l.kind == "conv":
        return torch.relu(_conv(x, p["w"], p["b"], l.stride))
    if l.kind == "res":
        return torch.relu(x + _conv(x, p["w"], p["b"], 1))
    if l.kind == "pool":                          # 2 x 2 / 2 max, VALID
        y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
        return y.permute(0, 2, 3, 1)
    if l.kind == "gap":
        return torch.mean(x, dim=(1, 2))
    if l.kind == "fc":
        return linear(x, p["w"], p["b"])
    raise ValueError(l.kind)


def apply_convnet(layers, params, x):
    for l, p in zip(layers, params):
        x = apply_layer(l, p, x)
    return x


def layer_flops_conv(l: Layer, hw: int, batch: int) -> float:
    if l.kind in ("conv", "res"):
        out_hw = hw // l.stride
        return 2.0 * batch * out_hw * out_hw * l.k * l.k * l.cin * l.cout
    if l.kind == "fc":
        return 2.0 * batch * l.cin * l.cout
    return 1.0 * batch * hw * hw


def trace_hw(layers: Sequence[Layer], hw: int) -> List[int]:
    """Input spatial size seen by each layer."""
    out, cur = [], hw
    for l in layers:
        out.append(cur)
        if l.kind == "pool" or (l.kind == "conv" and l.stride == 2):
            cur = cur // 2
        if l.kind == "gap":
            cur = 1
    return out


# ------------------------------------------------------------------ baselines
def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def prune_convnet(layers: Sequence[Layer], params: List[dict],
                  keep_frac: float) -> Tuple[List[Layer], List[dict]]:
    """Torch-Pruning-style structured magnitude pruning: keep the top
    ``keep_frac`` output channels by L2 norm (lossy: the paper's TPrg arm).
    The norms and the channel choice are the JAX package's numpy code; the
    kept weights come back as tensors on the params' device."""
    new_layers, new_params = [], []
    kept_prev: Optional[np.ndarray] = None

    def dev(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)

    for l, p in zip(layers, params):
        if l.kind == "conv":
            w = _host(p["w"])
            if kept_prev is not None:
                w = w[:, :, kept_prev, :]
            norms = np.linalg.norm(w.reshape(-1, w.shape[-1]), axis=0)
            k = max(1, int(round(l.cout * keep_frac)))
            keep = np.sort(np.argsort(norms)[-k:])
            new_layers.append(dataclasses.replace(
                l, cin=w.shape[2], cout=k))
            new_params.append({"w": dev(w[..., keep], p["w"]),
                               "b": dev(_host(p["b"])[keep], p["b"])})
            kept_prev = keep
        elif l.kind == "res":
            w = _host(p["w"])
            if kept_prev is not None:
                w = w[:, :, kept_prev, :][..., kept_prev]
            c = w.shape[2]
            new_layers.append(dataclasses.replace(l, cin=c, cout=c))
            new_params.append({"w": dev(w, p["w"]),
                               "b": dev(_host(p["b"])[kept_prev], p["b"])
                               if kept_prev is not None else p["b"]})
        elif l.kind == "fc":
            w = _host(p["w"])
            if kept_prev is not None:          # first fc after gap: slice cin
                w = w[kept_prev, :]
                kept_prev = None
            new_layers.append(dataclasses.replace(l, cin=w.shape[0]))
            new_params.append({"w": dev(w, p["w"]), "b": p["b"]})
        else:
            new_layers.append(l)
            new_params.append(p)
    return new_layers, new_params


def apply_convnet_channel_split(layers, params, x, groups: int = 4):
    """DCha baseline: convolution output channels computed in ``groups``
    sequential slices (1/groups weight memory at a time, combine overhead)."""
    for l, p in zip(layers, params):
        if l.kind == "conv" and l.cout >= groups:
            outs = []
            step = l.cout // groups
            w = materialize(p["w"])
            for g in range(groups):
                sl = slice(g * step, (g + 1) * step if g < groups - 1 else l.cout)
                outs.append(_conv(x, w[..., sl], p["b"][sl], l.stride))
            x = torch.relu(torch.cat(outs, dim=-1))
        else:
            x = apply_layer(l, p, x)
    return x
