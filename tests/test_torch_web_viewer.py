"""The browser viewer in gsjax_torch, against gsjax's.

- Camera math: `look_at`, `projection` (the port's from its own
  `core/transforms.projection_matrix`) and `orbit_matrices` agree with
  gsjax's within 1e-12.
- Local mode: `LocalModel.frame` of both packages on one model directory
  (a PLY of 60 gaussians, with and without `cfg_args`, whose absence makes
  both infer the degrees from the PLY) at a request that snaps to 64x64:
  the same (w, h) and verify string, the bytes within 1 LSB (gsjax on its
  XLA blend, the port on its twin). The HTTP endpoint serves the page, a
  frame of w*h*3 bytes and a 500 on a malformed request; a tile cap too
  small grows until no list is clamped, and the frame is then the same.
- Bridge mode: the port's `WebViewer` with `SIBRBridge` against the port's
  training server (a CPU run, tests/test_torch_viewer.py): one frame of the
  requested size, with the scene path as its verify string.
"""

import dataclasses
import http.client
import json
import os
import shutil
import time
from argparse import Namespace

import numpy as np
import pytest
import torch

from gsjax.viewer import web as jweb
from gsjax_torch.config import dump_cfg_args
from gsjax_torch.model import gaussians as tgm
from gsjax_torch.model.io import save_ply
from gsjax_torch.viewer import web as tweb
from tests.test_torch_viewer import _model, train_serving

torch.set_num_threads(1)


@pytest.mark.parametrize("yaw,pitch,radius,fovx,w,h", [
    (0.7, 0.4, 2.5, 1.2, 320, 160), (-2.0, -1.2, 7.0, 0.6, 64, 96), (0.0, 1.5, 1.0, 2.0, 33, 17)])
def test_camera_math_matches_gsjax(yaw, pitch, radius, fovx, w, h):
    target = [0.3, -0.2, 1.0]
    for a, b in zip(tweb.orbit_matrices(yaw, pitch, radius, target, fovx, w, h),
                    jweb.orbit_matrices(yaw, pitch, radius, target, fovx, w, h)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    pos = [radius * np.sin(yaw), -radius, pitch]
    np.testing.assert_allclose(tweb.look_at(pos, target), jweb.look_at(pos, target),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tweb.look_at([0.0, -5.0, 0.0], [0.0, 0.0, 0.0]),
                               jweb.look_at([0.0, -5.0, 0.0], [0.0, 0.0, 0.0]), atol=1e-12)
    np.testing.assert_allclose(tweb.projection(0.01, 100.0, fovx, 0.9),
                               jweb.projection(0.01, 100.0, fovx, 0.9), rtol=0, atol=1e-12)


def _req(w=70, h=66, **kw):
    return dict(yaw=0.3, pitch=0.25, radius=4.0, target=[0.0, 0.0, 4.0], fovx=1.3,
                width=w, height=h, scaling_modifier=0.9, train=True, **kw)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("web")
    tp, ta = tgm.params_from_numpy(*_model(), "cpu")
    with_cfg = str(root / "model")
    pdir = os.path.join(with_cfg, "point_cloud", "iteration_30")
    save_ply(os.path.join(pdir, "point_cloud.ply"), tp, ta)
    dump_cfg_args(with_cfg, Namespace(sh_degree=1, sg_degree=0, kernel_size=0.1,
                                      white_background=False))
    bare = str(root / "bare")
    shutil.copytree(pdir, os.path.join(bare, "point_cloud", "iteration_30"))
    return {"cfg_args": with_cfg, "inferred": bare}


@pytest.mark.parametrize("kind", ["cfg_args", "inferred"])
def test_local_model_frame_matches_gsjax(model_dirs, kind):
    tm = tweb.LocalModel(model_dirs[kind], device="cpu")
    jm = jweb.LocalModel(model_dirs[kind])
    assert (tm.iteration, tm.sh_degree, tm.sg_degree, tm.kernel_size) == \
        (jm.iteration, jm.sh_degree, jm.sg_degree, jm.kernel_size)
    assert tm.sh_degree == 1 and tm.iteration == 30
    tw, th, trgb, tv = tm.frame(_req())
    jw, jh, jrgb, jv = jm.frame(_req())
    name = os.path.basename(model_dirs[kind])
    assert (tw, th, tv) == (jw, jh, jv) == (64, 64, f"gsjax-local:{name}@it30")
    a = np.frombuffer(trgb, np.uint8).astype(int)
    b = np.frombuffer(jrgb, np.uint8).astype(int)
    assert a.size == 64 * 64 * 3 and np.abs(a - b).max() <= 1 and a.max() > 0


def test_local_model_http_and_tile_cap(model_dirs):
    model = tweb.LocalModel(model_dirs["cfg_args"], device="cpu")
    *_, want, _ = model.frame(_req())
    small = tweb.LocalModel(model_dirs["cfg_args"], device="cpu")
    small.cfg = dataclasses.replace(small.cfg, max_per_tile=4)
    *_, got, _ = small.frame(_req())
    assert small.cfg.max_per_tile > 4 and got == want
    viewer = tweb.WebViewer(model, "127.0.0.1", 0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", viewer.httpd.server_address[1],
                                          timeout=60)
        conn.request("GET", "/")
        r = conn.getresponse()
        assert r.status == 200 and b"gsjax_torch viewer" in r.read()
        conn.request("POST", "/frame", body=json.dumps(_req()))
        r = conn.getresponse()
        assert r.status == 200
        assert (r.getheader("X-Width"), r.getheader("X-Height")) == ("64", "64")
        assert r.getheader("X-Verify") == model.verify and r.read() == want
        conn.request("POST", "/frame", body="{bad json")
        r = conn.getresponse()
        assert r.status == 500
        r.read()
    finally:
        viewer.stop()


def test_bridge_mode_against_training_server(tmp_path):
    def client(port, log):
        for _ in range(2000):           # until the run's server listens
            try:
                bridge = tweb.SIBRBridge("127.0.0.1", port)
                break
            except OSError:
                time.sleep(0.01)
        viewer = tweb.WebViewer(bridge, "127.0.0.1", 0).start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", viewer.httpd.server_address[1],
                                              timeout=120)
            conn.request("POST", "/frame", body=json.dumps(
                dict(_req(48, 32), target=[0.0, 0.0, 0.0], radius=3.5)))
            r = conn.getresponse()
            return (r.status, r.getheader("X-Width"), r.getheader("X-Height"),
                    r.getheader("X-Verify"), r.read())
        finally:
            viewer.stop()
            bridge.close()

    scene_dir, _, trainer, _, (status, w, h, verify, rgb) = train_serving(
        tmp_path, client, iterations=3)
    assert status == 200 and (w, h) == ("48", "32") and verify == scene_dir
    assert len(rgb) == 48 * 32 * 3 and max(rgb) > 0
    assert trainer.iteration == 3
