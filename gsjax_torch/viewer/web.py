"""Browser-based interactive viewer, the SIBR GUI's stand-in (the port of
`gsjax/viewer/web.py`).

An HTTP server hosts a self-contained HTML/JS orbit page whose frames come
from either

  - **bridge mode** (`--connect host:port`): a live
    `python -m gsjax_torch.train --ip --port` run (or gsjax's), reached over
    the SIBR wire protocol: the browser watches and steers the run; or
  - **local mode** (`-m model_dir`): a trained model directory, rendered
    in-process by the port's `render()` (kernel B1 on the card), on cuda
    unless `--device cpu`.

Camera conventions match `gsjax_torch/cpp/sibr_client.cpp` and
`scene/cameras.py`: world->view built y-down looking at a target, GL-style
transposed wire layout with Y/Z column flips, projection with z in [0,1].

Usage:
    python -m gsjax_torch.viewer.web --connect 127.0.0.1:6009 [--http_port 8080]
    python -m gsjax_torch.viewer.web -m output/scan24 [--device cpu] [--http_port 8080]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from gsjax_torch.core.transforms import projection_matrix

# ---------------------------------------------------------------------------
# camera math (numpy; mirrors gsjax_torch/cpp/sibr_client.cpp:63-96)
# ---------------------------------------------------------------------------


def look_at(pos, target):
    """World->view for a camera at `pos` looking at `target`, COLMAP y-down
    (scene/cameras.py convention; sibr_client.cpp look_at_origin)."""
    pos = np.asarray(pos, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - pos
    fwd /= max(np.linalg.norm(fwd), 1e-12)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    n = np.linalg.norm(right)
    if n < 1e-6:             # looking straight along the pole
        right = np.array([1.0, 0.0, 0.0])
    else:
        right /= n
    down = np.cross(fwd, right)
    wv = np.eye(4)
    wv[0, :3], wv[1, :3], wv[2, :3] = right, down, fwd
    wv[:3, 3] = -wv[:3, :3] @ pos
    return wv


def projection(znear, zfar, fovx, fovy):
    """The training/render projection convention (the port's
    `core/transforms.projection_matrix`)."""
    return projection_matrix(znear, zfar, fovx, fovy).astype(np.float64)


def orbit_matrices(yaw, pitch, radius, target, fovx, width, height,
                   znear=0.01, zfar=100.0):
    """(world_view, full_proj, fovy) in plain math convention for an orbit
    camera: yaw/pitch around `target` at distance `radius` (y-down world,
    pitch>0 looks from above)."""
    cp = math.cos(pitch)
    d = np.array([cp * math.sin(yaw), -math.sin(pitch), -cp * math.cos(yaw)])
    pos = np.asarray(target, np.float64) + radius * d
    wv = look_at(pos, target)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    fp = projection(znear, zfar, fovx, fovy) @ wv
    return wv.astype(np.float32), fp.astype(np.float32), fovy


def encode_wire_message(world_view, full_proj, width, height, fovx, fovy,
                        train=True, keep_alive=True, scaling_modifier=1.0):
    """Plain-convention matrices -> the SIBR client JSON message
    (the exact inverse of NetworkGUI.receive's decoding)."""
    m = np.asarray(world_view, np.float32).T.copy()
    m[:, 1] *= -1
    m[:, 2] *= -1
    f = np.asarray(full_proj, np.float32).T.copy()
    f[:, 1] *= -1
    return dict(resolution_x=int(width), resolution_y=int(height),
                train=bool(train), fov_y=float(fovy), fov_x=float(fovx),
                z_near=0.01, z_far=100.0, shs_python=False,
                rot_scale_python=False, keep_alive=bool(keep_alive),
                scaling_modifier=float(scaling_modifier),
                view_matrix=[float(x) for x in m.reshape(-1)],
                view_projection_matrix=[float(x) for x in f.reshape(-1)])


# ---------------------------------------------------------------------------
# frame providers
# ---------------------------------------------------------------------------


class SIBRBridge:
    """SIBR-protocol TCP client: forwards camera requests to a running
    trainer (the `viewer/network_gui.py` server) and returns raw frames.
    One connection, requests serialized by a lock (the protocol is strictly
    request/response)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.host, self.port, self.timeout = host, port, timeout
        self.sock = None
        self.lock = threading.Lock()
        self._connect()

    def _connect(self):
        self.sock = socket.create_connection((self.host, self.port),
                                             self.timeout)
        self.sock.settimeout(self.timeout)

    def _recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("trainer closed the viewer socket")
            buf += chunk
        return buf

    def request(self, msg: dict):
        """-> (rgb bytes [h*w*3], verify string).

        The wire protocol is strictly request/response with no framing for
        resync: after ANY failure mid-exchange (e.g. a socket timeout while
        the trainer jit-compiles a new resolution) the stream position is
        unknown, so the connection is dropped and re-dialed on the next
        request rather than left permanently desynchronised."""
        w, h = msg["resolution_x"], msg["resolution_y"]
        payload = json.dumps(msg).encode("utf-8")
        with self.lock:
            try:
                if self.sock is None:
                    self._connect()
                self.sock.sendall(len(payload).to_bytes(4, "little"))
                self.sock.sendall(payload)
                rgb = self._recv_exact(w * h * 3) if w and h else b""
                vn = int.from_bytes(self._recv_exact(4), "little")
                verify = self._recv_exact(vn).decode("ascii")
            except (OSError, ConnectionError):
                self.close()
                self.sock = None
                raise
        return rgb, verify

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass

    def frame(self, req: dict):
        wv, fp, fovy = orbit_matrices(
            req["yaw"], req["pitch"], req["radius"], req["target"],
            req["fovx"], req["width"], req["height"])
        msg = encode_wire_message(
            wv, fp, req["width"], req["height"], req["fovx"], fovy,
            train=req.get("train", True), keep_alive=True,
            scaling_modifier=req.get("scaling_modifier", 1.0))
        rgb, verify = self.request(msg)
        return req["width"], req["height"], rgb, verify


class LocalModel:
    """In-process renderer over a trained model directory (render.py
    conventions: PLY + cfg_args) on `device` (cuda unless asked for the
    CPU). Resolutions snap to gsjax's 32-pixel grid, at most 1920x1088.
    The frame is colour only, so it renders without the median depth (the
    colour does not depend on it). The port sizes its pair buffers from the
    real counts, so an overflow can only be a tile list past
    `max_per_tile`, which then grows (no splat is dropped). One render at
    a time."""

    MAX_W, MAX_H = 1920, 1088

    def __init__(self, model_path: str, iteration: int = -1, device=None):
        from gsjax_torch import resolve_device
        from gsjax_torch.config import read_cfg_args
        from gsjax_torch.model.io import load_ply
        from gsjax_torch.ops.raster import RasterConfig
        from gsjax_torch.utils.system import search_max_iteration

        self.device = resolve_device(device)
        cfg_args = read_cfg_args(model_path)
        if iteration == -1:
            iteration = search_max_iteration(os.path.join(model_path, "point_cloud"))
        self.iteration = iteration
        self.params, self.aux = load_ply(os.path.join(
            model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply"),
            device=self.device)
        if not cfg_args:
            # the PLY's shapes pin the degrees; kernel_size and the
            # background fall to the reference defaults, said aloud
            print(f"WARNING: no cfg_args in {model_path}; inferring "
                  f"sh/sg degree from the PLY and using default "
                  f"kernel_size/background", flush=True)
        m_rest = self.params.features_rest.shape[1]        # (deg+1)^2 - 1
        self.sh_degree = int(cfg_args.get("sh_degree", round(math.sqrt(m_rest + 1)) - 1))
        self.sg_degree = int(cfg_args.get("sg_degree", self.params.sg_color.shape[1]))
        self.kernel_size = float(cfg_args.get("kernel_size", 0.1))
        self.bg = [1.0] * 3 if cfg_args.get("white_background", False) else [0.0] * 3
        self.verify = f"gsjax-local:{os.path.basename(model_path)}@it{iteration}"
        self.cfg = RasterConfig(sh_degree=self.sh_degree, sg_degree=self.sg_degree,
                                kernel_size=self.kernel_size, require_depth=False,
                                max_per_tile=1 << 12)
        self._lock = threading.Lock()

    @staticmethod
    def snap(width, height):
        w = max(64, min(LocalModel.MAX_W, (int(width) // 32) * 32))
        h = max(64, min(LocalModel.MAX_H, (int(height) // 32) * 32))
        return w, h

    def camera(self, req: dict):
        """The snapped orbit camera of a request: (camera, w, h)."""
        from gsjax_torch.ops.raster.camera import Camera

        w, h = self.snap(req["width"], req["height"])
        wv, fp, fovy = orbit_matrices(req["yaw"], req["pitch"], req["radius"],
                                      req["target"], req["fovx"], w, h)
        return Camera.from_matrices(w, h, req["fovx"], fovy, wv, fp, device=self.device), w, h

    def render(self, cam, scaling_modifier=1.0):
        """The port's `render()` of the model through `cam`, its tile cap
        grown until no list is clamped."""
        import torch

        import gsjax_torch.model.gaussians as gm
        from gsjax_torch.ops.raster import render

        p, aux = self.params, self.aux
        with torch.no_grad():
            scales, opac = gm.scaling_n_opacity_with_3d_filter(p, aux.filter_3d)
            scales = scales * float(np.float32(scaling_modifier))
            for _ in range(6):
                out = render(p.xyz, scales, p.rotation, opac, gm.get_features(p), cam,
                             self.cfg, self.bg, sg_axis=gm.get_sg_axis(p),
                             sg_sharpness=gm.get_sg_sharpness(p), sg_color=p.sg_color,
                             alive=aux.alive)
                mt = out["max_tile_count"]
                if mt <= self.cfg.max_per_tile:
                    break
                self.cfg = dataclasses.replace(
                    self.cfg, max_per_tile=1 << (max(mt, 1) - 1).bit_length())
        return out

    def frame(self, req: dict):
        import torch

        cam, w, h = self.camera(req)
        with self._lock:
            img = self.render(cam, req.get("scaling_modifier", 1.0))["render"]
            # contiguous on the device: the render is a channels-last view of
            # its planes (a strided host gather costs tens of ms at 1080p)
            u8 = (torch.clamp(img, 0, 1) * 255 + 0.5).to(torch.uint8).contiguous()
        return w, h, u8.cpu().numpy().tobytes(), self.verify


# ---------------------------------------------------------------------------
# HTTP server
# ---------------------------------------------------------------------------

_HTML = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>gsjax_torch viewer</title><style>
 body{margin:0;background:#111;color:#ccc;font:13px system-ui;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:rgba(0,0,0,.65);padding:8px 12px;
      border-radius:6px;user-select:none;z-index:2}
 #hud label{display:block;margin:3px 0}
 #hud input[type=range]{vertical-align:middle;width:130px}
 canvas{position:fixed;inset:0;width:100vw;height:100vh;image-rendering:auto}
 #stat{opacity:.7}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">
 <b>gsjax_torch viewer</b> <span id="stat"></span>
 <label>size <input id="res" type="range" min="0.25" max="1" step="0.05" value="0.75">
 </label>
 <label>splat scale <input id="sc" type="range" min="0.05" max="1" step="0.05" value="1">
 </label>
 <label>fov <input id="fov" type="range" min="0.4" max="2.2" step="0.05" value="1.4">
 </label>
 <label><input id="train" type="checkbox" checked> keep training</label>
 <span id="stat2"></span><br>
 <span style="opacity:.6">drag: orbit &middot; shift/right-drag: pan &middot;
 wheel: zoom</span>
</div>
<script>
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const S = {yaw: 0.0, pitch: 0.35, radius: 4.0, target: [0,0,0]};
let drag = null;
cv.oncontextmenu = e => e.preventDefault();
cv.onmousedown = e => { drag = {x: e.clientX, y: e.clientY,
                                pan: e.shiftKey || e.button === 2}; };
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) {
    // camera right / down axes from yaw+pitch (y-down world)
    const cy = Math.cos(S.yaw), sy = Math.sin(S.yaw);
    const cp = Math.cos(S.pitch), sp = Math.sin(S.pitch);
    // right = -right_cam, down = +down_cam of look_at(): with the
    // -= (dx*right - dy*down) update below, content moves opposite the
    // cursor on both axes (camera-pan convention).
    const right = [cy, 0, sy];
    const down = [-sy*sp, -cp, cy*sp];
    const k = 0.0018 * S.radius;
    for (let i = 0; i < 3; i++)
      S.target[i] -= k * (dx * right[i] - dy * down[i]);
  } else {
    S.yaw += dx * 0.005;
    S.pitch = Math.min(1.5, Math.max(-1.5, S.pitch + dy * 0.005));
  }
};
window.onwheel = e => { S.radius *= Math.exp(e.deltaY * 0.0012); };

const stat = document.getElementById('stat'),
      stat2 = document.getElementById('stat2');
let inflight = false, lastT = performance.now(), fps = 0;
async function tick() {
  if (inflight) return;
  inflight = true;
  const scale = parseFloat(document.getElementById('res').value);
  const w = Math.max(64, Math.round(window.innerWidth * scale / 32) * 32);
  const h = Math.max(64, Math.round(window.innerHeight * scale / 32) * 32);
  const req = {yaw: S.yaw, pitch: S.pitch, radius: S.radius,
               target: S.target, fovx: parseFloat(
                 document.getElementById('fov').value),
               width: w, height: h,
               scaling_modifier: parseFloat(
                 document.getElementById('sc').value),
               train: document.getElementById('train').checked};
  try {
    const r = await fetch('/frame', {method: 'POST',
                                     body: JSON.stringify(req)});
    if (!r.ok) throw new Error(await r.text());
    const rw = parseInt(r.headers.get('X-Width')),
          rh = parseInt(r.headers.get('X-Height'));
    const rgb = new Uint8Array(await r.arrayBuffer());
    const img = new ImageData(rw, rh);
    for (let i = 0, j = 0; i < rw * rh; i++) {
      img.data[i*4] = rgb[j++]; img.data[i*4+1] = rgb[j++];
      img.data[i*4+2] = rgb[j++]; img.data[i*4+3] = 255;
    }
    cv.width = rw; cv.height = rh;
    ctx.putImageData(img, 0, 0);
    const now = performance.now();
    fps = 0.8 * fps + 0.2 * (1000 / (now - lastT)); lastT = now;
    stat.textContent = rw + 'x' + rh + ' ' + fps.toFixed(1) + ' fps';
    stat2.textContent = r.headers.get('X-Verify') || '';
  } catch (err) {
    stat.textContent = 'error: ' + err.message;
    await new Promise(res => setTimeout(res, 500));
  }
  inflight = false;
}
setInterval(tick, 15);
</script></body></html>
"""


def make_handler(provider):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body = _HTML.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/frame":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n).decode("utf-8"))
                w, h, rgb, verify = provider.frame(req)
            except Exception as e:          # surface errors to the page
                msg = f"{type(e).__name__}: {e}".encode("utf-8")
                self.send_response(500)
                self.send_header("Content-Length", str(len(msg)))
                self.end_headers()
                self.wfile.write(msg)
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(rgb)))
            self.send_header("X-Width", str(w))
            self.send_header("X-Height", str(h))
            self.send_header("X-Verify", verify)
            self.end_headers()
            self.wfile.write(rgb)

    return Handler


class WebViewer:
    def __init__(self, provider, host="127.0.0.1", port=8080):
        self.httpd = ThreadingHTTPServer((host, port), make_handler(provider))
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)

    @property
    def url(self):
        h, p = self.httpd.server_address[:2]
        return f"http://{h}:{p}/"

    def start(self):
        self.thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--connect", default="",
                    help="host:port of a running training run's viewer server")
    ap.add_argument("-m", "--model_path", default="",
                    help="trained model dir to view locally")
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--http_host", default="127.0.0.1")
    ap.add_argument("--http_port", type=int, default=8080)
    ap.add_argument("--device", default=None,
                    help="local mode's torch device (default cuda; 'cpu' for "
                         "the plain-PyTorch path)")
    args = ap.parse_args(argv)
    if bool(args.connect) == bool(args.model_path):
        ap.error("exactly one of --connect or --model_path is required")
    if args.connect:
        host, port = args.connect.rsplit(":", 1)
        provider = SIBRBridge(host, int(port))
        print(f"bridging to trainer at {args.connect}")
    else:
        provider = LocalModel(args.model_path, args.iteration, args.device)
        print(f"loaded {args.model_path} (iteration {provider.iteration})")
    viewer = WebViewer(provider, args.http_host, args.http_port).start()
    print(f"viewer at {viewer.url}")
    try:
        viewer.thread.join()
    except KeyboardInterrupt:
        viewer.stop()


if __name__ == "__main__":
    main()
