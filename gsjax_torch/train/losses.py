"""Training losses (port of `gsjax/train/losses.py`).

Equivalents of `utils/loss_utils.py` (l1/ssim/L1_loss_appearance) and
`utils/graphics_utils.py:depth_to_normal`, in plain torch: in gsjax they are
XLA, not Pallas, so they have no kernel here either. Images are
channels-last [H,W,C]. SSIM matches fused-ssim semantics: 11x11 gaussian
window, sigma 1.5, padding='valid' (loss_utils.py:48-49), as gsjax's
separable shift-and-add blur (exact float32 arithmetic on every device; no
convolution library, whose float32 path may run in TF32 on the card).
"""

from __future__ import annotations

import numpy as np
import torch


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def l2_loss(a, b):
    return torch.mean((a - b) ** 2)


def psnr(img, gt):
    mse = torch.mean((img - gt) ** 2)
    return 20 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))


def _gaussian_window(size=11, sigma=1.5):
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    return [float(v) for v in (g / g.sum()).astype(np.float32)]


def _blur_valid(img, win):
    """Separable valid-mode gaussian filter of an [H,W,C] image."""
    k = len(win)
    h, w = img.shape[0], img.shape[1]
    x = sum(win[i] * img[:, i:w - k + 1 + i] for i in range(k))
    return sum(win[i] * x[i:h - k + 1 + i, :] for i in range(k))


def _ssim_map(img1, img2, window_size=11, sigma=1.5):
    """Clipped valid-mode SSIM map, [H-k+1, W-k+1, C]. Variances are clamped
    at 0 and the map clipped to [-1, 1], as in gsjax (early renders outside
    [0, 1] make E[x^2] - mu^2 cancel below zero in float32)."""
    win = _gaussian_window(window_size, sigma)
    mu1 = _blur_valid(img1, win)
    mu2 = _blur_valid(img2, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = torch.clamp_min(_blur_valid(img1 * img1, win) - mu1_sq, 0.0)
    s2 = torch.clamp_min(_blur_valid(img2 * img2, win) - mu2_sq, 0.0)
    s12 = _blur_valid(img1 * img2, win) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.clamp(ssim_map, -1.0, 1.0)


def ssim(img1, img2, window_size=11, sigma=1.5):
    """Mean SSIM over the valid region, [H,W,C] inputs."""
    return torch.mean(_ssim_map(img1, img2, window_size, sigma))


def ssim_partial(img1, img2, row_mask=None, window_size=11, sigma=1.5):
    """Masked partial SSIM sum of a band of rows (gsjax losses.py:74).

    img1 / img2: [Hs, W, C] row slices (a band of the valid map's rows plus
    the window's k - 1 halo rows below it); the valid map has Hs - k + 1 rows,
    summed where row_mask [Hs - k + 1] is True (None: all). The frame's mean
    is the sum of the bands' partials over (H - k + 1)(W - k + 1) C."""
    m = _ssim_map(img1, img2, window_size, sigma)
    if row_mask is not None:
        m = torch.where(row_mask[:, None, None], m, torch.zeros_like(m))
    return torch.sum(m)


def depth_to_normal(depth, fx, fy, cx, cy):
    """Camera-space normals from a z-depth map via central differences of
    back-projected points (utils/graphics_utils.py:103-119).

    depth: [H,W]. Returns (normal [H,W,3], valid [H,W] bool)."""
    h, w = depth.shape
    x = (torch.arange(w, dtype=torch.float32, device=depth.device) - cx) / fx
    y = (torch.arange(h, dtype=torch.float32, device=depth.device) - cy) / fy
    pts = torch.stack([depth * x[None, :], depth * y[:, None], depth], dim=-1)
    dy = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dx = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = torch.linalg.cross(dy, dx, dim=-1)
    # double-where normalisation: n / max(|n|, eps) has a NaN gradient at
    # |n| = 0 (flat or empty depth), which zero cotangents do not mask
    nrm2 = torch.sum(n * n, dim=-1, keepdim=True)
    good = nrm2 > 1e-20
    n = torch.where(good, n * torch.rsqrt(torch.where(good, nrm2, 1.0)),
                    torch.zeros_like(n))
    normal = torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))

    vd = depth > 0
    valid = torch.zeros_like(vd)
    valid[1:-1, 1:-1] = (vd[2:, 1:-1] & vd[:-2, 1:-1] & vd[1:-1, 2:]
                         & vd[1:-1, :-2] & vd[1:-1, 1:-1])
    return normal, valid


def depth_normal_loss(rendered_normal, depth_normal, valid):
    """1 - <n_render, n_depth> averaged (train.py:174-176)."""
    err = 1.0 - torch.sum(rendered_normal * depth_normal, dim=-1)
    return torch.mean(torch.where(valid, err, torch.zeros_like(err)))


# --- decoupled appearance ----------------------------------------------------

def l1_appearance_gs(image, gt, exposure):
    """GS exposure model: 3x4 affine per view (loss_utils.py:96-103)."""
    flat = image.reshape(-1, 3)
    mapped = flat @ exposure[:3, :3].T + exposure[:3, 3]
    return l1_loss(mapped.reshape(image.shape), gt)


def l1_appearance_pgsr(image, gt, embedding):
    """PGSR 2-param: exp(a)*img + b (loss_utils.py:121-123)."""
    return l1_loss(torch.exp(embedding[0]) * image + embedding[1], gt)


def img_grad_weight(img):
    """Normalised central-difference edge magnitude of an [H,W,3] image,
    padded with 1.0 at the border (loss_utils.py:75-87 get_img_grad_weight,
    parsed but unused in the reference training loop)."""
    gx = torch.mean(torch.abs(img[1:-1, 2:] - img[1:-1, :-2]), dim=-1)
    gy = torch.mean(torch.abs(img[:-2, 1:-1] - img[2:, 1:-1]), dim=-1)
    g = torch.maximum(gx, gy)
    g = (g - g.min()) / torch.clamp_min(g.max() - g.min(), 1e-12)
    return torch.nn.functional.pad(g, (1, 1, 1, 1), value=1.0)
