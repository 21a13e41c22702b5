"""LPIPS (VGG) perceptual metric, the port's own copy of the JAX package's
``utils.lpips`` (the metric of svox2's opt/calc_metrics.py:31,
``lpips.LPIPS(net='vgg')``): torchvision's VGG16 feature trunk,
per-channel unit normalisation, the learned 1x1 linear heads, spatial
averaging; on the device it is given.

The repository ships no weights and the port fetches none, so the weights
are files: ``make_lpips`` looks for them in ``$LPIPS_WEIGHTS_DIR`` (or at
the paths given) and returns ``None`` when they are absent; callers report
LPIPS only when the metric exists.

Weight files (state dicts in torch.save format):
  * vgg16.pth        torchvision ``vgg16(weights=IMAGENET1K_V1)``
                     (``features.N.weight/bias`` keys)
  * lpips_vgg.pth    the lpips package's ``LPIPS(net='vgg')`` heads
                     (``lin{k}.model.1.weight`` keys)
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..core.device import resolve_device

# VGG16 "features" (torchvision): conv widths, "M" a max pool
_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]
# feature taps after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_SLICE_ENDS = (4, 9, 16, 23, 30)
_CHNS = (64, 128, 256, 512, 512)


def _build_vgg_features() -> nn.Sequential:
    layers, in_ch = [], 3
    for v in _VGG16_CFG:
        if v == "M":
            layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
        else:
            layers += [nn.Conv2d(in_ch, v, kernel_size=3, padding=1), nn.ReLU(inplace=True)]
            in_ch = v
    return nn.Sequential(*layers)


class LPIPSVgg:
    """LPIPS-vgg over numpy (H, W, 3) images in [0, 1], computed on
    ``device``."""

    def __init__(self, vgg_state: dict, lin_state: dict, device="cuda"):
        self.device = resolve_device(device)
        self.features = _build_vgg_features()
        self.features.load_state_dict({k.split("features.", 1)[1]: v
                                       for k, v in vgg_state.items()
                                       if k.startswith("features.")})
        self.features.eval().requires_grad_(False).to(self.device)
        self.lins = []
        for k, ch in enumerate(_CHNS):
            w = next((lin_state[key] for key in (f"lin{k}.model.1.weight",
                                                 f"lins.{k}.model.1.weight")
                      if key in lin_state), None)
            if w is None:
                raise KeyError(f"lin weights for tap {k} not found")
            lin = nn.Conv2d(ch, 1, 1, bias=False)
            lin.weight.data = w
            self.lins.append(lin.eval().requires_grad_(False).to(self.device))
        # the input scaling of lpips.ScalingLayer
        self.shift = torch.tensor([-0.030, -0.088, -0.188], device=self.device).view(1, 3, 1, 1)
        self.scale = torch.tensor([0.458, 0.448, 0.450], device=self.device).view(1, 3, 1, 1)

    def _feats(self, x):
        outs, prev = [], 0
        for end in _SLICE_ENDS:
            for i in range(prev, end):
                x = self.features[i](x)
            prev = end
            outs.append(x)
        return outs

    @staticmethod
    def _unit_normalize(t, eps=1e-10):
        return t / ((t ** 2).sum(dim=1, keepdim=True).sqrt() + eps)

    @torch.no_grad()
    def __call__(self, img0: np.ndarray, img1: np.ndarray) -> float:
        """The LPIPS distance of two (H, W, 3) images in [0, 1]."""
        def prep(im):
            t = torch.from_numpy(np.asarray(im, np.float32).transpose(2, 0, 1)[None].copy())
            return (t.to(self.device) * 2.0 - 1.0 - self.shift) / self.scale

        f0, f1 = self._feats(prep(img0)), self._feats(prep(img1))
        val = 0.0
        for k in range(len(_CHNS)):
            d = (self._unit_normalize(f0[k]) - self._unit_normalize(f1[k])) ** 2
            val = val + self.lins[k](d).mean(dim=(2, 3))
        return float(val.reshape(()))


def make_lpips(vgg_path: Optional[str] = None, lin_path: Optional[str] = None,
               device="cuda") -> Optional[LPIPSVgg]:
    """The metric on ``device`` when both weight files exist, else None."""
    base = os.environ.get("LPIPS_WEIGHTS_DIR", "")
    vgg_path = vgg_path or (os.path.join(base, "vgg16.pth") if base else "")
    lin_path = lin_path or (os.path.join(base, "lpips_vgg.pth") if base else "")
    if not (vgg_path and lin_path and os.path.isfile(vgg_path) and os.path.isfile(lin_path)):
        return None
    vgg_state = torch.load(vgg_path, map_location="cpu", weights_only=True)
    lin_state = torch.load(lin_path, map_location="cpu", weights_only=True)
    return LPIPSVgg(vgg_state, lin_state, device=device)
