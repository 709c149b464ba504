"""Remote live-view server: the SIBR-compatible socket protocol (port of
hlod_gaussians_tpu/viewer/server.py:27-149; socket and numpy code, copied
so that this package imports nothing of the JAX package).

Wire-compatible re-implementation of the reference's network GUI
(gaussian_renderer/network_gui.py:26-89) + the interactive SPT viewer loop
(hierarchy_viewer.py:98-546): a TCP listener receives JSON view requests
  {resolution_x/y, fov_x/y, z_near/far, view_matrix[16],
   view_projection_matrix[16], scaling_modifier, slider, train, keep_alive}
framed as a 4-byte little-endian length and the JSON, and replies with the
raw H*W*3 uint8 image, then a 4-byte little-endian length and the status
JSON. The Y/Z column sign flips match the reference's SIBR convention.

The server is renderer-agnostic: pass a `render_fn(camera, opts) ->
np.uint8 [H,W,3]`, typically a closure over render_lod with the sliders
driving the LOD granularity, as cli.make_viewer builds it.
"""

from __future__ import annotations

import json
import socket
import traceback
from typing import Callable, Optional, Tuple

import numpy as np


class MiniCam:
    """View parameters decoded from a client request (reference
    scene/cameras.py MiniCam)."""

    def __init__(self, width, height, fovy, fovx, znear, zfar,
                 world_view, full_proj):
        self.width = int(width)
        self.height = int(height)
        self.fovx = float(fovx)
        self.fovy = float(fovy)
        self.znear = float(znear)
        self.zfar = float(zfar)
        self.world_view = world_view            # [4,4] row-vector convention
        self.full_proj = full_proj
        inv = np.linalg.inv(world_view)
        self.campos = inv[3, :3]
        self.tan_fovx = float(np.tan(fovx / 2))
        self.tan_fovy = float(np.tan(fovy / 2))


class ViewerServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None
        # overrides for the per-frame JSON status payload (the reference
        # viewer's verify blob, hierarchy_viewer.py:538-539)
        self.status: dict = {}

    @property
    def port(self) -> int:
        return self.listener.getsockname()[1]

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            return True
        except (BlockingIOError, socket.timeout):
            return False

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client closed")
            buf += chunk
        return buf

    def read(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def send(self, image_bytes: Optional[bytes], verify: str) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    @staticmethod
    def decode_camera(msg: dict) -> Optional[Tuple[MiniCam, dict]]:
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None
        wv = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] = -wv[:, 1]
        wv[:, 2] = -wv[:, 2]
        fp = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        fp[:, 1] = -fp[:, 1]
        cam = MiniCam(width, height, msg["fov_y"], msg["fov_x"],
                      msg["z_near"], msg["z_far"], wv, fp)
        opts = dict(
            train=bool(msg.get("train", False)),
            keep_alive=bool(msg.get("keep_alive", True)),
            scaling_modifier=float(msg.get("scaling_modifier", 1.0)),
            slider=msg.get("slider", {}),
        )
        return cam, opts

    def poll_once(self, render_fn: Callable) -> Optional[dict]:
        """Serve one request if a client is connected. Returns the decoded
        options (or None). On protocol errors the connection is dropped, as
        in the reference's training-loop try/except.

        The verify payload is the reference viewer's JSON status blob
        (hierarchy_viewer.py:538-539) built from ``self.status`` — the app
        updates the dict (num_gaussians, train_params...) between polls."""
        if not self.try_connect():
            return None
        try:
            msg = self.read()
            decoded = self.decode_camera(msg)
            if decoded is None:
                self.send(None, "")
                return {}
            cam, opts = decoded
            img = render_fn(cam, opts)
            img = np.ascontiguousarray(img, dtype=np.uint8)
            status = dict(iteration=99, num_gaussians=0, loss=0,
                          sh_degree=1, error=0, paused=False,
                          train_params={})
            status.update(self.status)
            self.send(memoryview(img).tobytes(), json.dumps(status))
            return opts
        except Exception:
            traceback.print_exc()
            try:
                self.conn.close()
            finally:
                self.conn = None
            return None

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        self.listener.close()
