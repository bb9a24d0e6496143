"""gsjax_torch `preprocess` against gsjax `preprocess` and the numpy oracle.

All 12 `Preprocessed` fields. Integer fields must be equal; float fields
agree within atol 1e-5 times the field's largest finite magnitude (float32
math in both packages, summed in another order; the oracle is float64).
The VJP (torch autograd against `jax.vjp`, seeded cotangents on the float
fields but the depth sort key) agrees within atol 1e-5 of each input's
largest gradient on every alive slot, and is finite there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.ops.raster import RasterConfig as JConfig
from gsjax.ops.raster.preprocess import preprocess as jpreprocess
from gsjax_torch.ops.raster import RasterConfig as TConfig
from gsjax_torch.ops.raster.camera import Camera as TCamera
from gsjax_torch.ops.raster.preprocess import preprocess as tpreprocess
from tests.oracle import preprocess_np
from tests.util import look_at_camera, random_gaussians

torch.set_num_threads(1)
W, H = 96, 64
INT_FIELDS = ("radius", "rect_min", "rect_wh", "tiles_touched", "valid")
FLOAT_FIELDS = ("mean2d", "depth", "conic", "opacity", "color", "ray_plane", "normal")
CASES = {
    "base": dict(),
    "kernel_size": dict(kernel_size=0.3),
    "sg": dict(sg_degree=2),
    "dead_slots": dict(dead=True),
    "behind_camera": dict(behind=True, sg_degree=2, kernel_size=0.3),
}
GRAD_FIELDS = ("mean2d", "conic", "opacity", "color", "ray_plane", "normal")


def _scene(case):
    means, scales, q, op, shs = random_gaussians(160, seed=11)
    rng = np.random.default_rng(12)
    sg_axis = rng.normal(0, 1, (160, 2, 3)).astype(np.float32)
    sg_axis /= np.linalg.norm(sg_axis, axis=2, keepdims=True)
    sg_sharp = rng.uniform(0.5, 3.0, (160, 2)).astype(np.float32)
    sg_color = rng.normal(0, 0.3, (160, 2, 3)).astype(np.float32)
    if case.get("behind"):
        means[:4, 2] = -np.abs(means[:4, 2])      # behind the camera: culled
    alive = (np.arange(160) % 5 != 0) if case.get("dead") else None
    kw = dict(sh_degree=2, sg_degree=case.get("sg_degree", 0),
              kernel_size=case.get("kernel_size", 0.0))
    return (means, scales, q, op, shs[:, :9]), (sg_axis, sg_sharp, sg_color), alive, kw


def _run(case):
    g, sg, alive, kw = _scene(case)
    jcam = look_at_camera(W, H, angle=0.2)
    tcam = TCamera.create(np.asarray(jcam.view_rotation).T, np.zeros(3, np.float32),
                          0.9, 0.7, W, H, device="cpu")
    sgj = sg if kw["sg_degree"] else (None, None, None)
    pj = jpreprocess(*map(jnp.asarray, g), *(None if a is None else jnp.asarray(a) for a in sgj),
                     jcam, JConfig(**kw), None if alive is None else jnp.asarray(alive))
    pt = tpreprocess(*map(torch.as_tensor, g),
                     *(None if a is None else torch.as_tensor(a) for a in sgj),
                     tcam, TConfig(**kw), None if alive is None else torch.as_tensor(alive))
    return pj, pt, g, sg, alive, kw, jcam


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return (request.param,) + _run(CASES[request.param])


def _scale(ref):
    fin = np.abs(ref[np.isfinite(ref)])
    return max(float(fin.max()) if fin.size else 1.0, 1e-12)


def test_fields_match_gsjax(case):
    _, pj, pt, *_ = case
    for f in dataclasses.fields(pt):
        want = np.asarray(getattr(pj, f.name))
        got = getattr(pt, f.name).numpy()
        assert got.shape == want.shape, f.name
        if f.name in INT_FIELDS:
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * _scale(want),
                                       err_msg=f.name)


def test_fields_match_oracle(case):
    name, _, pt, g, sg, alive, kw, jcam = case
    sg_kw = dict(zip(("sg_axis", "sg_sharpness", "sg_color"), sg)) if kw["sg_degree"] else {}
    ref = preprocess_np(*g, jcam, kw["sh_degree"], kernel_size=kw["kernel_size"],
                        sg_degree=kw["sg_degree"], **sg_kw)
    keep = [i for i, r in enumerate(ref) if r is not None and (alive is None or alive[i])]
    valid = pt.valid.numpy()
    assert valid.sum() == len(keep) and valid[keep].all()
    assert len(keep) > 50, "scene must keep most gaussians in view"
    for field in FLOAT_FIELDS:
        want = np.stack([np.asarray(ref[i][field], np.float64) for i in keep])
        got = getattr(pt, field).numpy()[keep].astype(np.float64)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * _scale(want),
                                   err_msg=f"{name}: {field}")
    np.testing.assert_array_equal(pt.radius.numpy()[keep], [ref[i]["radius"] for i in keep])
    rect = np.stack([ref[i]["rect"] for i in keep])
    np.testing.assert_array_equal(pt.rect_min.numpy()[keep], rect[:, :2])
    np.testing.assert_array_equal(pt.rect_wh.numpy()[keep], rect[:, 2:] - rect[:, :2])


def test_vjp_matches_gsjax(case):
    name, _, _, g, sg, alive, kw, jcam = case
    tcam = TCamera.create(np.asarray(jcam.view_rotation).T, np.zeros(3, np.float32),
                          0.9, 0.7, W, H, device="cpu")
    use_sg = bool(kw["sg_degree"])
    inputs = list(g) + (list(sg) if use_sg else [])
    alive_j = None if alive is None else jnp.asarray(alive)

    def jfn(*a):
        sgj = a[5:] if use_sg else (None, None, None)
        p = jpreprocess(*a[:5], *sgj, jcam, JConfig(**kw), alive_j)
        return {f: getattr(p, f) for f in GRAD_FIELDS}

    out, vjp = jax.vjp(jfn, *map(jnp.asarray, inputs))
    rng = np.random.default_rng(3)
    cts = {f: rng.normal(0, 1, np.shape(v)).astype(np.float32) for f, v in out.items()}
    want = vjp({f: jnp.asarray(c) for f, c in cts.items()})

    args = [torch.tensor(a, requires_grad=True) for a in inputs]
    sgt = args[5:] if use_sg else (None, None, None)
    pt = tpreprocess(*args[:5], *sgt, tcam, TConfig(**kw),
                     None if alive is None else torch.as_tensor(alive))
    loss = sum((getattr(pt, f) * torch.as_tensor(cts[f])).sum() for f in GRAD_FIELDS)
    got = torch.autograd.grad(loss, args)
    rows = np.ones(len(g[0]), bool) if alive is None else alive
    for i, (w, t) in enumerate(zip(want, got)):
        w, t = np.asarray(w)[rows], t.numpy()[rows]
        assert np.isfinite(t).all(), f"{name}: non-finite gradient of input {i}"
        np.testing.assert_allclose(t, w, rtol=0, atol=1e-5 * _scale(w),
                                   err_msg=f"{name}: input {i}")
