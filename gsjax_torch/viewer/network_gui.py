"""Live-viewer TCP server speaking the SIBR remote-viewer protocol (the
port's copy of `gsjax/viewer/network_gui.py`, numpy and sockets only).

Wire-compatible with `gaussian_renderer/network_gui.py:26-86`: 4-byte little-
endian length-prefixed JSON camera messages in, raw RGB bytes + length-
prefixed verify string out. The SIBR C++ client from the reference (or any
3DGS-protocol viewer) can connect to a gsjax_torch training run.

The incoming matrices are GL-style *transposed* (row-vector) with flipped
Y/Z axes — they are converted to the plain math convention here.
"""

from __future__ import annotations

import json
import socket

import numpy as np


class NetworkGUI:
    def __init__(self, host="127.0.0.1", port=6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn = None

    def try_connect(self):
        if self.conn is not None:
            return
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nViewer connected by {addr}")
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout, OSError):
            pass

    def _read(self):
        n = int.from_bytes(self.conn.recv(4), "little")
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer closed")
            buf += chunk
        return json.loads(buf.decode("utf-8"))

    def receive(self):
        """Returns (cam_dict | None, do_training, keep_alive, scaling_modifier).

        cam_dict has width/height/world_view [4,4]/full_proj [4,4] in plain
        math convention (matrices act on column vectors)."""
        msg = self._read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            # no frame requested (render widget hidden) — the training/
            # keep-alive flags still apply, else a hidden widget would pin
            # the trainer inside the serve loop (reference network_gui.py
            # returns them unconditionally)
            return (None, bool(msg["train"]), bool(msg["keep_alive"]),
                    float(msg["scaling_modifier"]))
        wv = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] *= -1
        wv[:, 2] *= -1
        fp = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        fp[:, 1] *= -1
        cam = dict(width=width, height=height,
                   fovx=msg["fov_x"], fovy=msg["fov_y"],
                   world_view=wv.T, full_proj=fp.T)   # transpose: row-vec -> col-vec
        return (cam, bool(msg["train"]), bool(msg["keep_alive"]),
                float(msg["scaling_modifier"]))

    def send(self, image_u8: np.ndarray | None, verify: str):
        """image_u8: [H,W,3] uint8 or None."""
        if image_u8 is not None:
            self.conn.sendall(np.ascontiguousarray(image_u8).tobytes())
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def disconnect(self):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self):
        """Drop the connection and stop listening (frees the port)."""
        self.disconnect()
        self.listener.close()
