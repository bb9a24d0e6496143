"""The live viewer's server side in gsjax_torch, against gsjax's.

- The wire layer: a client's camera message, sent to the port's and to
  gsjax's `NetworkGUI`, decodes to equal matrices and flags (exact), and
  `encode_wire_message` of both packages builds the same message.
- `Trainer.render_camera` with `scaling_modifier` and `min_opacity`, against
  gsjax's on the same params (gsjax on its XLA blend, the port on its twin):
  colour and alpha within 3e-5, the render parity tolerance of
  `tests/test_torch_render.py`.
- A training run (`python -m gsjax_torch.train --ip --port`, 64x32 scene on
  the CPU, from a checkpoint of the scene's gaussians) serves a Python
  client that connects during set-up: its paused frame (before step 1)
  equals gsjax's `render_camera` of the same model as uint8 within 1 LSB,
  the verify string is the scene path, and the run trains on once the
  client lets it go. gsjax's render is used, not gsjax's loop, which
  compiles for minutes (tests/test_viewer.py:120-127).
- The port's `sibr_client`, built with g++, against the same kind of run:
  its orbit frames land in PPMs of the requested size.
"""

import json
import os
import socket
import subprocess
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax_torch.train as ttrain
from gsjax.model import gaussians as jgm
from gsjax.ops.raster.camera import Camera as JCamera
from gsjax.train import loop as jloop
from gsjax.viewer import web as jweb
from gsjax.viewer.network_gui import NetworkGUI as JGUI
from gsjax_torch.model import gaussians as tgm
from gsjax_torch.model.io import load_checkpoint
from gsjax_torch.ops.raster.camera import Camera as TCamera
from gsjax_torch.train import loop as tloop
from gsjax_torch.viewer import web as tweb
from gsjax_torch.viewer.client import client_path
from gsjax_torch.viewer.network_gui import NetworkGUI as TGUI
from tests.test_torch_train import _start
from tests.util import random_gaussians

torch.set_num_threads(1)
W, H = 64, 32


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def connect(port, deadline=120.0):
    """A client socket to 127.0.0.1:port, retried until the server listens."""
    end = time.time() + deadline
    while True:
        try:
            c = socket.create_connection(("127.0.0.1", port), timeout=0.5)
            c.settimeout(120)
            return c
        except OSError:
            if time.time() > end:
                raise
            time.sleep(0.01)


def send_msg(conn, msg: dict):
    payload = json.dumps(msg).encode("utf-8")
    conn.sendall(len(payload).to_bytes(4, "little") + payload)


def recv_exact(conn, n):
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("closed")
        buf += chunk
    return buf


def recv_frame(conn, w, h):
    """-> (uint8 [h, w, 3], verify string)."""
    rgb = np.frombuffer(recv_exact(conn, w * h * 3), np.uint8).reshape(h, w, 3)
    return rgb, recv_exact(conn, int.from_bytes(recv_exact(conn, 4), "little")).decode()


def orbit_message(w, h, train, keep_alive, scaling=1.0, yaw=0.4):
    wv, fp, fovy = tweb.orbit_matrices(yaw, 0.3, 3.5, [0.0, 0.0, 0.0], 1.2, w, h)
    return tweb.encode_wire_message(wv, fp, w, h, 1.2, fovy, train=train,
                                    keep_alive=keep_alive, scaling_modifier=scaling)


def train_serving(root, client, iterations=3, port=None, extra=()):
    """Run the port's train CLI on the CPU (64x32 scene from a checkpoint of
    its gaussians) with the viewer server on `port` while `client(port,
    log)` runs in a thread; `log` gets (time, metrics) per step. Returns
    (scene dir, checkpoint, trainer, log, client's result)."""
    scene_dir, ckpt = _start(root, width=W, height=H)
    port = port or free_port()
    log, result = [], {}

    def run():
        try:
            result["value"] = client(port, log)
        except Exception as e:        # surfaced by the asserts of the caller
            result["error"] = repr(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    trainer = ttrain.main(["-s", scene_dir, "-m", str(root / "out"), "--iterations",
                           str(iterations), "--start_checkpoint", ckpt, "--device", "cpu",
                           "--ip", "127.0.0.1", "--port", str(port), *extra],
                          on_step=lambda tr, m: log.append((time.time(), m)))
    t.join(120)
    assert not t.is_alive(), "the client did not finish"
    assert "error" not in result, result["error"]
    return scene_dir, ckpt, trainer, log, result["value"]


def test_wire_layer_matches_gsjax():
    msg = orbit_message(48, 32, train=False, keep_alive=True, scaling=0.7, yaw=1.1)
    wv, fp, fovy = jweb.orbit_matrices(1.1, 0.3, 3.5, [0.0, 0.0, 0.0], 1.2, 48, 32)
    assert jweb.encode_wire_message(wv, fp, 48, 32, 1.2, fovy, train=False,
                                    keep_alive=True, scaling_modifier=0.7) == msg
    got = []
    for cls in (TGUI, JGUI):
        port = free_port()
        gui = cls("127.0.0.1", port)
        client = connect(port)
        for _ in range(200):
            gui.try_connect()
            if gui.conn is not None:
                break
            time.sleep(0.01)
        send_msg(client, msg)
        got.append(gui.receive())
        gui.send(np.full((32, 48, 3), 7, np.uint8), "ok")
        rgb, verify = recv_frame(client, 48, 32)
        assert verify == "ok" and (rgb == 7).all()
        client.close()
        gui.disconnect()
        gui.listener.close()
    (tc, *tflags), (jc, *jflags) = got
    assert tflags == jflags == [False, True, pytest.approx(0.7)]
    assert sorted(tc) == sorted(jc)
    for k in tc:
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)
    np.testing.assert_allclose(tc["world_view"], wv, atol=1e-7)


def _model(n=60, cap=64):
    means, scales, q, op, shs = random_gaussians(n, seed=11)
    pad = lambda x, fill=0.0: np.concatenate(
        [x, np.full((cap - n,) + x.shape[1:], fill, np.float32)]).astype(np.float32)
    params = dict(xyz=pad(means), features_dc=pad(shs[:, :1]), features_rest=pad(shs[:, 1:4]),
                  opacity=pad(np.log(op / (1 - op))[:, None]), scaling=pad(np.log(scales)),
                  rotation=pad(q), sg_axis=pad(np.zeros((n, 1, 3))),
                  sg_sharpness=pad(np.zeros((n, 1))), sg_color=pad(np.zeros((n, 1, 3))))
    params["rotation"][n:, 0] = 1.0
    aux = dict(alive=np.arange(cap) < n, filter_3d=np.full(cap, 0.004, np.float32),
               grad_accum=np.zeros(cap, np.float32), grad_accum_abs=np.zeros(cap, np.float32),
               denom=np.zeros(cap, np.float32), max_radii=np.zeros(cap, np.int32))
    return params, aux


def _gsjax_trainer(params, aux, kernel_size=0.0, active_sh=0):
    jp = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    ja = jgm.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()})
    return jloop.Trainer(scene=None, params=jp, aux=ja, adam=None, app=None, opt=None,
                         model_path="", kernel_size=kernel_size, active_sh=active_sh,
                         pair_capacity=1 << 12, live_capacity=1 << 12, max_per_tile=256)


@pytest.mark.parametrize("scaling,min_opacity", [(1.0, 0.0), (0.7, 0.45)])
def test_render_camera_matches_gsjax(scaling, min_opacity):
    params, aux = _model()
    jt = _gsjax_trainer(params, aux, kernel_size=0.1, active_sh=1)
    tp, ta = tgm.params_from_numpy(params, aux, "cpu")
    tt = tloop.Trainer(scene=None, params=tp, aux=ta, adam=None, opt=None, model_path="",
                       device=torch.device("cpu"), kernel_size=0.1, active_sh=1)
    wv, fp, fovy = tweb.orbit_matrices(0.2, 0.1, 4.0, [0.0, 0.0, 4.0], 1.1, 96, 64)
    jo = jt.render_camera(JCamera.from_matrices(96, 64, 1.1, fovy, wv, fp),
                          scaling_modifier=scaling, require_depth=False,
                          min_opacity=min_opacity)
    to = tt.render_camera(TCamera.from_matrices(96, 64, 1.1, fovy, wv, fp, device="cpu"),
                          scaling_modifier=scaling, require_depth=False,
                          min_opacity=min_opacity)
    for k in ("render", "alpha"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), atol=3e-5, err_msg=k)
    assert float(to["alpha"].max()) > 0.5
    if min_opacity:
        full = tt.render_camera(TCamera.from_matrices(96, 64, 1.1, fovy, wv, fp, device="cpu"),
                                scaling_modifier=scaling, require_depth=False)
        assert int((full["radii"] > 0).sum()) > int((to["radii"] > 0).sum()) > 0


def test_training_server_serves_the_model(tmp_path):
    """A paused frame before step 1 is gsjax's render of the starting model."""
    msgs = [orbit_message(W, H, train=False, keep_alive=True, scaling=0.8),
            orbit_message(W, H, train=False, keep_alive=True, scaling=0.8),
            orbit_message(W, H, train=True, keep_alive=False)]

    def client(port, log):
        c = connect(port)
        frames = []
        try:
            for m in msgs:
                send_msg(c, m)
                frames.append(recv_frame(c, W, H))
            return dict(frames=frames, steps_before_release=len(log))
        finally:
            c.close()

    scene_dir, ckpt, trainer, log, res = train_serving(tmp_path, client)
    assert trainer.iteration == 3 and len(log) == 3
    assert res["steps_before_release"] == 0, "the client connected before step 1"
    (f0, v0), (f1, _), (_, v2) = res["frames"]
    assert v0 == v2 == scene_dir
    np.testing.assert_array_equal(f0, f1)     # paused: the model did not move

    p, a, *_ = load_checkpoint(ckpt, device="cpu")
    jt = _gsjax_trainer(*tgm.params_to_numpy(p, a), kernel_size=trainer.kernel_size)
    # the wire's decode is exact (test_wire_layer_matches_gsjax)
    wv, fp, fovy = jweb.orbit_matrices(0.4, 0.3, 3.5, [0.0, 0.0, 0.0], 1.2, W, H)
    out = jt.render_camera(JCamera.from_matrices(W, H, 1.2, fovy, wv, fp),
                           scaling_modifier=0.8, require_depth=False)
    want = np.asarray(jnp.clip(out["render"], 0, 1) * 255).astype(np.uint8)
    assert np.abs(f0.astype(int) - want.astype(int)).max() <= 1
    assert f0.max() > 0


def test_native_client_against_training_server(tmp_path):
    exe = client_path()
    assert os.access(exe, os.X_OK) and client_path() == exe    # built once
    prefix = str(tmp_path / "orbit")

    def client(port, log):
        end = time.time() + 120
        while True:      # sibr_client exits at once when nothing listens yet
            r = subprocess.run([exe, "127.0.0.1", str(port), "48", "32", "2", prefix,
                                "0.9", "3.5"], capture_output=True, text=True, timeout=120)
            if "connect" not in r.stderr or time.time() > end:
                return r
            time.sleep(0.01)

    scene_dir, _, trainer, log, res = train_serving(tmp_path, client, iterations=4,
                                                    port=None)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count(f"(scene: {scene_dir})") == 2
    assert trainer.iteration == 4
    for i in range(2):
        with open(f"{prefix}_{i:03d}.ppm", "rb") as f:
            assert f.readline().strip() == b"P6"
            assert f.readline().split() == [b"48", b"32"]
            f.readline()
            img = np.frombuffer(f.read(), np.uint8)
        assert img.size == 48 * 32 * 3 and img.max() > 0
