"""One gsjax_torch `train_step` against gsjax's from identical state.

The state is carried across by `params_from_numpy`. From zero moments one
Adam step leaves mu = 0.1 g and nu = 0.001 g^2, so the moments hold the
gradients; they are compared, not the updated parameters: the first Adam
step is lr * sign(g), and a gradient that is float noise (|g| near 0) flips
sign between the packages. Parameters are compared where |g| is above a
floor of 1e-3 of the field's largest gradient.

reg off: gsjax on its XLA blend (`render_ref`), the port on its twin.
reg on (depth-normal loss, median depth live): gsjax on its Pallas blend in
interpret mode, whose B2 carries the implicit-function median gradient
(autodiff through gsjax's XLA bisection is float32 noise,
tests/test_pallas.py:79-82).

mv on (reg on plus the PGSR multi-view losses against a neighbour view
moved by a small rotation and a shift): gsjax on its Pallas blend and point
kernel in interpret mode, as reg on; its NCC samples with `_bilinear`.

app gs / pgsr / gof (reg off, each appearance model mapping the render
before its L1 term): gsjax on its XLA blend, from the same seeded embedding
row (and, for gof, the port's initial CNN weights carried across as
arrays); the step's embedding gradient, the net's gradients and one Adam
step of the net's moments are compared under the reg-off tolerances.

Tolerances: loss metrics, densification statistics and max_radii within
1e-5; moments within 1e-5 of each field's largest gradient. With reg on,
what the median depth feeds (the depth-normal loss, and through it the
geometry fields xyz / scaling / rotation / opacity and the mean2d
statistics) is held looser, because the two find the root of T(t) = 0.5 by
different searches (7-step Newton with a 5-sigma cull in gsjax's kernel,
8-way bisection in the twin; tests/test_torch_render.py holds the depths to
atol 2e-3 / rtol 1e-3): dn_loss within rtol 1e-3 (read: 1.5e-4), those
moments and statistics within 5e-3 of scale (read: at most 1.9e-3 on 1% of
elements), and parameters compared above a floor of 2e-2. With mv on,
ncc_loss / geo_loss and the total loss that carries them are held within
rtol 1e-3 (read: 1.6e-4), and the geometry moments within 1e-2 of scale:
the geometric loss differentiates the neighbour's median depth at each
query point, and where the model T(t) bends sharply the two searches' roots
(read: 1.5e-5 apart at most) carry derivatives a few percent apart (read:
3% at one of 270 points, which moves one gaussian's xyz moment by 8.7e-3 of
scale; every other element within 5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.model import appearance as japp
from gsjax.model import gaussians as jgm
from gsjax.ops.raster import Camera as JCamera
from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.raster import render as jrender
from gsjax.train.step import LossConfig as JLoss
from gsjax.train.step import train_step as jstep
from gsjax_torch.model import appearance as tapp
from gsjax_torch.model import gaussians as tgm
from gsjax_torch.ops.raster import RasterConfig as TConfig
from gsjax_torch.ops.raster.camera import Camera as TCamera
from gsjax_torch.train.step import LossConfig as TLoss
from gsjax_torch.train.step import train_step as tstep
from tests.util import look_at_camera, random_gaussians

torch.set_num_threads(1)
W, H = 64, 32
N, CAP = 60, 72
LRS = dict(xyz=1.6e-4, features_dc=0.0025, features_rest=0.0001, opacity=0.05,
           scaling=0.005, rotation=0.001, sg_axis=0.002, sg_sharpness=0.095,
           sg_color=0.00064)


def _near():
    """The neighbour view's (R, T): a small rotation about y and a shift."""
    a = 0.08
    r = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                 np.float32)
    return r, np.array([-0.15, 0.0, 0.0], np.float32)


def _luma(img):
    img = np.asarray(img)
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).astype(np.float32)


def _state():
    """A covering model (so the median depth and the depth-normal loss are
    live) with dead slots past N, a gt image from another scene, and the
    luma frames of that scene in the reference and the neighbour view."""
    means, scales, q, op, shs = random_gaussians(N, seed=5)
    pad = lambda x, fill=0.0: np.concatenate(
        [x, np.full((CAP - N,) + x.shape[1:], fill, np.float32)]).astype(np.float32)
    rng = np.random.default_rng(2)
    params = dict(xyz=pad(means), features_dc=pad(shs[:, :1]), features_rest=pad(shs[:, 1:4]),
                  opacity=pad(np.log(op / (1 - op))[:, None]), scaling=pad(np.log(scales)),
                  rotation=pad(q), sg_axis=pad(rng.normal(0, 1, (N, 1, 3))),
                  sg_sharpness=pad(np.zeros((N, 1))), sg_color=pad(np.zeros((N, 1, 3))))
    params["rotation"][N:, 0] = 1.0
    aux = dict(alive=np.arange(CAP) < N, filter_3d=np.full(CAP, 0.005, np.float32),
               grad_accum=np.zeros(CAP, np.float32), grad_accum_abs=np.zeros(CAP, np.float32),
               denom=np.zeros(CAP, np.float32), max_radii=np.zeros(CAP, np.int32))
    g = random_gaussians(70, seed=7)
    gcfg = JConfig(sh_degree=1, require_depth=False, chunk=128, max_per_tile=256,
                   pair_capacity=1 << 12, backend="ref")
    gt, gt_near = (np.array(jrender(*map(jnp.asarray, (g[0], g[1], g[2], g[3], g[4][:, :4])),
                                    cam, gcfg, jnp.zeros(3))["render"])
                   for cam in (look_at_camera(W, H), JCamera.create(*_near(), 0.9, 0.7, W, H)))
    return params, aux, gt, _luma(gt), _luma(gt_near)


def _appearance(kind):
    """A seeded embedding row of `kind` and, for gof, the port's CNN with its
    weights as gsjax's {layer: {"w", "b"}} tree: (row, port net, gsjax net)."""
    rng = np.random.default_rng(9)
    if kind == "gs":
        row = np.eye(3, 4) + rng.normal(0, 0.05, (3, 4))
    elif kind == "pgsr":
        row = rng.normal(0, 0.1, 2)
    else:
        row = rng.normal(0, 0.5, 64)
    if kind != "gof":
        return row.astype(np.float32), None, None
    net = tapp.GofNet(torch.Generator().manual_seed(3))
    jnet = {k: {kk: jnp.asarray(vv.detach().numpy()) for kk, vv in p.items()}
            for k, p in net.tree().items()}
    return row.astype(np.float32), net, jnet


def _step(mode):
    reg_on, mv_on = mode in ("reg_on", "mv_on"), mode == "mv_on"
    kind = mode[4:] if mode.startswith("app_") else "no"
    params, aux, gt, gray_r, gray_n = _state()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    kw = dict(tile=32, max_per_tile=256, sh_degree=1, require_depth=reg_on)
    jcfg = JConfig(chunk=128, tile_batch=2, pair_capacity=1 << 12,
                   backend="pallas" if reg_on else "ref", **kw)
    jp = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    ja = jgm.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()})
    jmv = tmv = {}
    if mv_on:
        jmv = dict(near_cam=JCamera.create(*_near(), 0.9, 0.7, W, H),
                   gray_r=jnp.asarray(gray_r), gray_n=jnp.asarray(gray_n))
        tmv = dict(near_cam=TCamera.create(*_near(), 0.9, 0.7, W, H, device="cpu"),
                   gray_r=torch.as_tensor(gray_r), gray_n=torch.as_tensor(gray_n))
    if kind != "no":
        row, net, jnet = _appearance(kind)
        jmv = dict(app_embedding=jnp.asarray(row), app_net=jnet)
        tmv = dict(app_embedding=torch.as_tensor(row), app_net=net)
    jp2, ja2, jad2, jm = jstep(jp, ja, jgm.adam_init(jp), look_at_camera(W, H),
                               jnp.asarray(gt), jnp.asarray(bg), LRS, jcfg,
                               JLoss(reg_on=reg_on, mv_on=mv_on, appearance=kind), **jmv)
    tp, ta = tgm.params_from_numpy(params, aux, "cpu")
    tcam = TCamera.create(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                          0.9, 0.7, W, H, device="cpu")
    tad = tgm.adam_init(tp)
    tp2, ta2, tad2, tm = tstep(tp, ta, tad, tcam, torch.as_tensor(gt), torch.as_tensor(bg),
                               LRS, TConfig(chunk=128, backend="torch", **kw),
                               TLoss(reg_on=reg_on, mv_on=mv_on, appearance=kind), **tmv)
    return mode, params, (jp2, ja2, jad2, jm), (tp2, ta2, tad2, tm)


@pytest.fixture(scope="module",
                params=["reg_off", "reg_on", "mv_on", "app_gs", "app_pgsr", "app_gof"])
def stepped(request):
    return _step(request.param)


GEOMETRY = ("xyz", "scaling", "rotation", "opacity")


def test_step_metrics_and_stats_match(stepped):
    mode, _, (_, ja2, _, jm), (_, ta2, _, tm) = stepped
    reg_on = mode in ("reg_on", "mv_on")
    assert not tm["overflowed"]
    for k in ("loss", "l1", "ssim", "dn_loss", "ncc_loss", "geo_loss"):
        loose = k in ("dn_loss", "ncc_loss", "geo_loss") or (k == "loss" and mode == "mv_on")
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-3 if loose else 1e-5,
                                   atol=1e-6, err_msg=k)
    if reg_on:
        assert tm["dn_loss"] > 0, "the depth-normal loss must be live"
    if mode == "mv_on":
        assert tm["ncc_loss"] > 0 and tm["geo_loss"] > 0, "the multi-view losses must be live"
        assert tm["mv_queries"] > 0
    for k in ("num_pairs", "num_live_pairs", "max_tile_count"):
        assert tm[k] == int(jm[k]), k
    for k in ("grad_accum", "grad_accum_abs", "denom", "max_radii"):
        want = np.asarray(getattr(ja2, k))
        tol = 5e-3 if reg_on and k.startswith("grad") else 1e-5
        np.testing.assert_allclose(getattr(ta2, k).numpy(), want, rtol=0,
                                   atol=tol * max(np.abs(want).max(), 1.0), err_msg=k)
    assert float(ta2.grad_accum.sum()) > 0


def test_step_moments_and_params_match(stepped):
    mode, _, (jp2, _, jad2, _), (tp2, _, tad2, _) = stepped
    reg_on = mode in ("reg_on", "mv_on")
    floor = 2e-2 if reg_on else 1e-3
    assert tad2.count == int(jad2.count) == 1
    for k in tgm.PARAM_FIELDS:
        tol = ({"reg_on": 5e-3, "mv_on": 1e-2}[mode] if reg_on and k in GEOMETRY
               else 1e-5)
        for name, want, got in (("mu", getattr(jad2.mu, k), tad2.mu[k]),
                                ("nu", getattr(jad2.nu, k), tad2.nu[k])):
            want = np.asarray(want)
            scale = max(np.abs(want).max(), 1e-20)
            np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=tol,
                                       err_msg=f"{name} {k}")
        g = np.asarray(getattr(jad2.mu, k)) / 0.1
        big = np.abs(g) > floor * max(np.abs(g).max(), 1e-20)
        np.testing.assert_allclose(getattr(tp2, k).detach().numpy()[big],
                                   np.asarray(getattr(jp2, k))[big], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(tad2.mu["xyz"][N:].abs().max()) == 0.0, "dead slots get no gradient"
    assert np.isfinite(tad2.mu["xyz"].numpy()).all()


def _scaled(got, want, tol, what):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-20)
    np.testing.assert_allclose(got.detach().numpy() / scale, want / scale, atol=tol,
                               err_msg=what)


def test_step_appearance_grads_match(stepped):
    """The embedding row's gradient (and the GOF net's, and one Adam step of
    the net's moments from zero) against gsjax's."""
    mode, _, (_, _, _, jm), (_, _, _, tm) = stepped
    if not mode.startswith("app_"):
        assert tm["app_grad"] is None and tm["app_net_grad"] is None
        return
    assert float(tm["app_grad"].abs().max()) > 0
    _scaled(tm["app_grad"], jm["app_grad"], 1e-5, "app_grad")
    if mode != "app_gof":
        assert tm["app_net_grad"] is None
        return
    jg = jm["app_net_grad"]
    tg = tm["app_net_grad"]
    for k in jg:
        for kk in jg[k]:
            _scaled(tg[k][kk], jg[k][kk], 1e-5, f"{k}/{kk}")
    zeros = lambda tree, f: {k: {kk: f(v) for kk, v in p.items()} for k, p in tree.items()}
    _, jopt = jax.jit(lambda g, st: japp.adam_tree(g, g, st, 1e-3))(
        jg, japp.TableAdam(zeros(jg, jnp.zeros_like), zeros(jg, jnp.zeros_like), jnp.int32(0)))
    _, topt = tapp.adam_tree(tg, tg, tapp.TableAdam(zeros(tg, torch.zeros_like),
                                                    zeros(tg, torch.zeros_like), 0), 1e-3)
    for k in jg:
        for kk in jg[k]:
            _scaled(topt.mu[k][kk], jopt.mu[k][kk], 1e-5, f"mu {k}/{kk}")
            _scaled(topt.nu[k][kk], jopt.nu[k][kk], 1e-5, f"nu {k}/{kk}")
