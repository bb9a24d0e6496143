"""LPIPS perceptual metric (VGG16 backbone) in torch (port of
`gsjax/eval/lpips.py`).

Equivalent of the vendored `lpipsPyTorch/` package. The architecture is
self-contained; pretrained VGG16 + linear-head weights are not in the
repository and cannot be downloaded offline, so they are loaded from an
`.npz` pointed to by `GSJAX_LPIPS_WEIGHTS` (the file gsjax's
`convert_torch_weights` writes; `convert_state_dicts` below makes the same
layout). Without weights, `lpips()` returns None and the metric CLI reports
`LPIPS: null`.

Expected npz keys: conv{i}_w [OIHW], conv{i}_b for the 13 VGG16 convs, and
lin{k}_w [1,C,1,1] for the 5 LPIPS linear heads; shift/scale normalisation
constants are built in. The convolutions are library calls (`F.conv2d`):
gsjax runs them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
_SLICE_AFTER = {1: 0, 3: 1, 6: 2, 9: 3, 12: 4}  # conv index -> head index
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def load_weights():
    """The weights under `GSJAX_LPIPS_WEIGHTS`, or None where no file is
    there."""
    path = os.environ.get("GSJAX_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    return dict(np.load(path))


def _vgg_features(weights, x):
    """x: [H,W,3] after shift/scale. Returns the 5 feature maps [1,C,h,w]."""
    feats = []
    conv_i = 0
    h = x.permute(2, 0, 1)[None]                     # [1,3,H,W]
    for c in _VGG_CFG:
        if c == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        h = F.relu(F.conv2d(h, weights[f"conv{conv_i}_w"],
                            weights[f"conv{conv_i}_b"], padding=1))
        if conv_i in _SLICE_AFTER:
            feats.append(h)
        conv_i += 1
    return feats


@torch.no_grad()
def lpips(img1, img2, weights=None):
    """img1/img2: [H,W,3] in [0,1] (tensors, or numpy arrays for the CPU).
    Runs on img1's device. Returns a float, or None if no weights."""
    weights = weights or load_weights()
    if weights is None:
        return None
    a = torch.as_tensor(img1, dtype=torch.float32)
    b = torch.as_tensor(img2, dtype=torch.float32, device=a.device)
    w = {k: torch.as_tensor(np.asarray(v, np.float32), device=a.device)
         for k, v in weights.items()}
    shift = torch.as_tensor(_SHIFT, device=a.device)
    scale = torch.as_tensor(_SCALE, device=a.device)
    f1 = _vgg_features(w, (2 * a - 1 - shift) / scale)
    f2 = _vgg_features(w, (2 * b - 1 - shift) / scale)
    total = 0.0
    for k, (p, q) in enumerate(zip(f1, f2)):
        pn = p / torch.clamp_min(torch.linalg.vector_norm(p, dim=1, keepdim=True), 1e-10)
        qn = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=1, keepdim=True), 1e-10)
        total = total + torch.mean(torch.sum((pn - qn) ** 2 * w[f"lin{k}_w"], dim=1))
    return float(total)


# torchvision VGG16 `features` module indices of the 13 convs (convs at
# 0,2 | 5,7 | 10,12,14 | 17,19,21 | 24,26,28 with ReLU/MaxPool between)
_TV_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def convert_state_dicts(vgg_features_sd, lin_weights, out_path=None):
    """Convert raw state dicts to the npz key layout `lpips()` expects.

    vgg_features_sd: torchvision-layout dict with `features.N.weight/bias`
    for the VGG16 convs; lin_weights: the 5 LPIPS linear-head weights, each
    [1, C, 1, 1] (lpips pkg `lins[k].model[-1].weight`). Tensors or numpy
    arrays; no torchvision/lpips import needed."""
    as_np = lambda t: t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
    arrs = {}
    for i, n in enumerate(_TV_CONV_IDX):
        arrs[f"conv{i}_w"] = as_np(vgg_features_sd[f"features.{n}.weight"])
        arrs[f"conv{i}_b"] = as_np(vgg_features_sd[f"features.{n}.bias"])
    for k, w in enumerate(lin_weights):
        w = as_np(w)
        if not (w.ndim == 4 and w.shape[0] == 1 and w.shape[2:] == (1, 1)):
            raise ValueError(f"LPIPS head {k} has shape {w.shape}, want [1, C, 1, 1]")
        arrs[f"lin{k}_w"] = w
    if out_path:
        np.savez(out_path, **arrs)
    return arrs
