"""Decoupled appearance models (port of `gsjax/model/appearance.py`;
the reference's `scene/gaussian_model.py:271-302` and
`scene/appearance_network.py`):

  - "gs":   a per-view 3x4 exposure matrix (initialised to the identity);
  - "pgsr": a per-view (log-gain, bias) pair (initialised to zeros);
  - "gof":  a per-view 64-d embedding and a CNN (`GofNet`) that maps the
    rendered image, downsampled 32x, and the embedding to a per-pixel RGB
    multiplier in (0, 1).

The embedding table is optimised with whole-table Adam, as the torch
reference: unselected rows get a zero gradient, but their moments decay and
they still move. Adam here is functional (`adam_tree` returns new tensors);
the table and the net are small (C x 64 and ~0.26 M weights).

The random initialisation draws from a `torch.Generator`, so it is not
gsjax's (jax.random's stream): parity with gsjax comes from carrying state
across with `state_from_arrays`, which also loads gsjax's checkpoints.
The CNN's convolutions are `F.conv2d`: gsjax runs them through XLA, outside
any Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

KINDS = ("no", "gs", "pgsr", "gof")
EMBED_DIM = 64
# (name, in channels, out channels) of the GOF CNN (gsjax's init_gof_net :153)
GOF_LAYERS = (("conv1", 3 + EMBED_DIM, 256), ("up1", 256 // 4, 128), ("up2", 128 // 4, 64),
              ("up3", 64 // 4, 32), ("up4", 32 // 4, 16), ("conv2", 16, 16), ("conv3", 16, 3))


@dataclasses.dataclass
class TableAdam:
    """Adam moments of a tensor or of a {layer: {"w", "b"}} tree, and the
    step count."""
    mu: object
    nu: object
    count: int


class GofNet(nn.Module):
    """GOF's appearance CNN (scene/appearance_network.py): 3x3 SAME
    convolutions (OIHW weights) with ReLU, four pixel-shuffle x2 stages, a
    bilinear x2 upsample with aligned corners, and a sigmoid."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        for name, cin, cout in GOF_LAYERS:
            conv = nn.Conv2d(cin, cout, 3, padding=1)
            # torch's Conv2d default (kaiming-uniform, a = sqrt(5)): weights
            # and biases uniform in +-1/sqrt(fan_in), as gsjax's _conv_init
            bound = float(np.sqrt(1.0 / (cin * 9)))
            with torch.no_grad():
                for p in (conv.weight, conv.bias):
                    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
            setattr(self, name, conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[1, 3 + 64, H/32, W/32] -> [1, 3, H, W] multiplier in (0, 1)
        (gsjax's `gof_forward`)."""
        x = F.relu(self.conv1(x))
        for name in ("up1", "up2", "up3", "up4"):
            x = F.relu(getattr(self, name)(F.pixel_shuffle(x, 2)))
        x = upsample_x2_align(x)
        x = F.relu(self.conv2(x))
        return torch.sigmoid(self.conv3(x))

    def tree(self) -> dict:
        """{layer: {"w": weight, "b": bias}}: gsjax's parameter tree."""
        return {name: {"w": getattr(self, name).weight, "b": getattr(self, name).bias}
                for name, _, _ in GOF_LAYERS}

    @torch.no_grad()
    def load_tree(self, tree: dict):
        for name, p in tree.items():
            getattr(self, name).weight.copy_(torch.as_tensor(p["w"]))
            getattr(self, name).bias.copy_(torch.as_tensor(p["b"]))


@dataclasses.dataclass
class AppearanceState:
    kind: str                          # no | gs | pgsr | gof
    table: torch.Tensor | None         # [C, ...] per-view embeddings
    net: GofNet | None                 # the GOF CNN
    opt: TableAdam | None
    net_opt: TableAdam | None


def _zeros_like(x):
    if isinstance(x, dict):
        return {k: _zeros_like(v) for k, v in x.items()}
    return torch.zeros_like(x)


def init_appearance(kind: str, num_cams: int, generator: torch.Generator | None = None,
                    device=None) -> AppearanceState:
    """A fresh model of `kind` for `num_cams` views (random draws from
    `generator`, a CPU generator; tensors on `device`)."""
    if kind == "no":
        return AppearanceState("no", None, None, None, None)
    if kind == "gs":
        table = torch.eye(3, 4).repeat(num_cams, 1, 1)
    elif kind == "pgsr":
        table = torch.zeros(num_cams, 2)
    elif kind == "gof":
        table = 1e-4 * torch.randn(num_cams, EMBED_DIM, generator=generator)
    else:
        raise ValueError(f"unknown appearance model {kind!r}; one of {KINDS}")
    table = table.to(device)
    net = net_opt = None
    if kind == "gof":
        net = GofNet(generator).to(device)
        net_opt = TableAdam(_zeros_like(_detached(net.tree())),
                            _zeros_like(_detached(net.tree())), 0)
    opt = TableAdam(torch.zeros_like(table), torch.zeros_like(table), 0)
    return AppearanceState(kind, table, net, opt, net_opt)


def _detached(tree):
    return {k: {kk: vv.detach() for kk, vv in v.items()} for k, v in tree.items()}


def adam_tree(params, grads, state: TableAdam, lr: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-15):
    """One Adam step of a tensor or a {layer: {name: tensor}} tree (gsjax's
    `adam_tree`, eps 1e-15 as the reference's table optimisers). Returns
    (new params, new TableAdam); nothing is updated in place."""
    lr = float(lr)
    count = state.count + 1
    c = np.float32(count)
    bc1 = np.float32(1) - np.float32(b1) ** c
    bc2 = np.float32(1) - np.float32(b2) ** c

    def upd(p, g, mu, nu):
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        return p - lr * (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + eps), mu, nu

    if isinstance(params, dict):
        out = {k: {kk: upd(params[k][kk].detach(), grads[k][kk], state.mu[k][kk],
                           state.nu[k][kk]) for kk in params[k]} for k in params}
        pick = lambda i: {k: {kk: o[i] for kk, o in v.items()} for k, v in out.items()}
        return pick(0), TableAdam(pick(1), pick(2), count)
    p, mu, nu = upd(params.detach(), grads, state.mu, state.nu)
    return p, TableAdam(mu, nu, count)


def update_table(state: AppearanceState, uid: int, grad_row: torch.Tensor,
                 lr: float) -> AppearanceState:
    """Whole-table Adam step with the gradient scattered into row `uid`."""
    grads = torch.zeros_like(state.table)
    grads[uid] = grad_row
    table, opt = adam_tree(state.table, grads, state.opt, lr)
    return dataclasses.replace(state, table=table, opt=opt)


def update_net(state: AppearanceState, grads: dict, lr: float) -> AppearanceState:
    """Adam step of the GOF net's weights (in the module, in place) from a
    {layer: {"w", "b"}} gradient tree."""
    tree, net_opt = adam_tree(_detached(state.net.tree()), grads, state.net_opt, lr)
    state.net.load_tree(tree)
    return dataclasses.replace(state, net_opt=net_opt)


# --- checkpoint (de)serialisation --------------------------------------------
#
# The reference's capture() / restore() include the appearance nets and their
# optimiser state (scene/gaussian_model.py:88-144); these flatten the state
# into gsjax's path-keyed arrays for the npz checkpoint.

def state_to_arrays(app: AppearanceState) -> dict:
    """{path: ndarray} of the table, the net and both Adam states, under
    gsjax's keys (app/table, app/opt/{mu,nu,count}, app/net/<layer>/<w|b>,
    app/net_opt/{mu,nu}/<layer>/<w|b>, app/net_opt/count)."""
    np_ = lambda t: t.detach().cpu().numpy()
    out = {}
    if app.table is not None:
        out["app/table"] = np_(app.table)
        out["app/opt/mu"] = np_(app.opt.mu)
        out["app/opt/nu"] = np_(app.opt.nu)
        out["app/opt/count"] = np.asarray(app.opt.count, np.int32)
    if app.net is not None:
        for layer, p in app.net.tree().items():
            for k, v in p.items():
                out[f"app/net/{layer}/{k}"] = np_(v)
                out[f"app/net_opt/mu/{layer}/{k}"] = np_(app.net_opt.mu[layer][k])
                out[f"app/net_opt/nu/{layer}/{k}"] = np_(app.net_opt.nu[layer][k])
        out["app/net_opt/count"] = np.asarray(app.net_opt.count, np.int32)
    return out


def state_from_arrays(app: AppearanceState, arrs: dict) -> AppearanceState:
    """`app` with the parts that `arrs` holds (gsjax's keys, from either
    package; numpy arrays) restored on `app`'s device: the inverse of
    `state_to_arrays`. Absent keys leave `app` untouched; the legacy
    'app_table' key restores the table only."""
    if app.kind == "no":
        return app
    dev = app.table.device
    t = lambda a: torch.tensor(np.asarray(a), device=dev)
    if "app_table" in arrs and "app/table" not in arrs:   # legacy checkpoints
        return dataclasses.replace(app, table=t(arrs["app_table"]))
    if "app/table" not in arrs:
        return app
    opt = TableAdam(t(arrs["app/opt/mu"]), t(arrs["app/opt/nu"]),
                    int(arrs["app/opt/count"]))
    net_opt = app.net_opt
    if app.net is not None and "app/net_opt/count" in arrs:
        layers = [name for name, _, _ in GOF_LAYERS]
        app.net.load_tree({layer: {k: t(arrs[f"app/net/{layer}/{k}"]) for k in ("w", "b")}
                           for layer in layers})
        tree = lambda m: {layer: {k: t(arrs[f"app/net_opt/{m}/{layer}/{k}"])
                                  for k in ("w", "b")} for layer in layers}
        net_opt = TableAdam(tree("mu"), tree("nu"), int(arrs["app/net_opt/count"]))
    return dataclasses.replace(app, table=t(arrs["app/table"]), opt=opt, net_opt=net_opt)


# --- the GOF mapping (loss_utils.py:105-119) ---------------------------------

def upsample_x2_align(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample of [N, C, H, W] with aligned corners (gsjax's
    `_bilinear_x2_align`)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def downsample_align(img: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """Bilinear resize with aligned corners of [H, W, C] -> [h_out, w_out, C]
    (F.interpolate in loss_utils.py:113)."""
    x = F.interpolate(img.permute(2, 0, 1)[None], size=(h_out, w_out), mode="bilinear",
                      align_corners=True)
    return x[0].permute(1, 2, 0)


def gof_mapped(image: torch.Tensor, gt: torch.Tensor, net: GofNet,
               embedding: torch.Tensor):
    """GOF's appearance mapping of an [H, W, 3] render. Returns (mapped,
    crop_gt), both [h, w, 3] centre crops to the /32 grid."""
    h0, w0 = image.shape[:2]
    h, w = h0 // 32 * 32, w0 // 32 * 32
    top, left = (h0 - h) // 2, (w0 - w) // 2
    crop = image[top:top + h, left:left + w]
    crop_gt = gt[top:top + h, left:left + w]
    down = downsample_align(crop, h // 32, w // 32)                  # [h/32, w/32, 3]
    emb = embedding[None, None, :].expand(h // 32, w // 32, EMBED_DIM)
    net_in = torch.cat([down, emb], -1).permute(2, 0, 1)[None]        # [1, 67, h/32, w/32]
    mapping = net(net_in)[0]                                           # [3, h, w]
    return mapping.permute(1, 2, 0) * crop, crop_gt


def l1_appearance_gof(image, gt, net: GofNet, embedding):
    """GOF's appearance L1 (loss_utils.py:105-119); image / gt [H, W, 3]."""
    mapped, crop_gt = gof_mapped(image, gt, net, embedding)
    return torch.mean(torch.abs(mapped - crop_gt))
