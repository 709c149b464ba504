"""Port parity for the live viewer (viewer/server.py and cli.py's
`viewer`: `_res_bucket`, `make_viewer`, `cmd_viewer`) against the JAX
package on the CPU.

* the SIBR framing, byte for byte: tests/test_aux.py's golden transcript
  and its replay of tests/fixtures/viewer/sibr_request.bin, served by both
  packages' ViewerServer, give the same reply bytes and the same decoded
  cameras; a malformed request drops the connection in both;
* `_res_bucket` equal to the JAX package's at every bucket edge;
* `cmd_viewer` on one tiny .dhier in both packages, each with its
  ViewerServer replaced by a stub that feeds the same requests to the
  render_fn (the fixture's, realistic views, a render_SPTs and a
  freeze_view request) and interrupts after the last: the served uint8
  frames within 1 LSB and the status JSON equal. The JAX package renders
  with its plain (xla) path, the port with its pallas backend (its kernel
  wrapper on the plain version)."""

import argparse
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from hlod_gaussians_tpu import cli as jcli
from hlod_gaussians_tpu.data import dhier as jdhier
from hlod_gaussians_tpu.hierarchy import build as jhb
from hlod_gaussians_tpu.utils import camera as jcam
from hlod_gaussians_tpu.viewer import server as jserver
from hlod_gaussians_torch import cli
from hlod_gaussians_torch.viewer import server

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "viewer",
                       "sibr_request.bin")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame(msg: dict) -> bytes:
    payload = json.dumps(msg).encode()
    return len(payload).to_bytes(4, "little") + payload


def fixture_messages():
    raw = open(FIXTURE, "rb").read()
    out, i = [], 0
    while i < len(raw):
        n = int.from_bytes(raw[i:i + 4], "little")
        out.append(json.loads(raw[i + 4:i + 4 + n]))
        i += 4 + n
    return out


def serve(server_cls, raw: bytes, replies, render_fn, status):
    """Serve ``raw`` (framed requests) from a client thread; ``replies`` is
    the image size of each expected reply (0: a keepalive's empty one).
    Returns the bytes the client read and the poll results."""
    srv = server_cls(port=0)
    srv.status = dict(status)
    got = {}

    def client():
        s = socket.create_connection(("127.0.0.1", srv.port))
        s.sendall(raw)

        def recv_exact(n):
            b = b""
            while len(b) < n:
                chunk = s.recv(n - len(b))
                if not chunk:
                    raise ConnectionError("server closed")
                b += chunk
            return b
        out = b""
        for size in replies:
            out += recv_exact(size)
            head = recv_exact(4)
            out += head + recv_exact(int.from_bytes(head, "little"))
        got["bytes"] = out
        s.close()

    t = threading.Thread(target=client)
    t.start()
    polls = []
    deadline = time.monotonic() + 20.0
    while len(polls) < len(replies) and time.monotonic() < deadline:
        r = srv.poll_once(render_fn)
        if r is not None:
            polls.append(r)
        else:
            time.sleep(0.002)
    t.join(timeout=10)
    srv.close()
    assert not t.is_alive() and len(polls) == len(replies)
    return got["bytes"], polls


def recording_render(seen):
    def render_fn(cam, opts):
        seen.append(dict(wv=cam.world_view.copy(), fp=cam.full_proj.copy(),
                         campos=cam.campos.copy(),
                         tan=(cam.tan_fovx, cam.tan_fovy),
                         wh=(cam.width, cam.height), opts=opts))
        return np.full((cam.height, cam.width, 3), 7, np.uint8)
    return render_fn


def golden_message():
    vm = np.diag([1.0, 1.0, 1.0, 1.0])
    vm[3, :3] = [0.5, -0.25, 2.0]
    return dict(resolution_x=32, resolution_y=24, fov_x=0.8, fov_y=0.6,
                z_near=0.01, z_far=100.0, train=False, shs_python=False,
                rot_scale_python=False, keep_alive=True,
                scaling_modifier=1.0, slider={"lod": 0.5},
                view_matrix=list(vm.flatten().astype(float)),
                view_projection_matrix=list(
                    np.eye(4).flatten().astype(float)))


@pytest.mark.parametrize("case", ["golden", "fixture"])
def test_server_replies_match_jax_byte_for_byte(case):
    """test_aux.py:83's golden transcript and :157's fixture replay, served
    by both packages: the same reply bytes (image, LE32 length, status
    JSON; an empty frame for the keepalive) and the same decoded cameras
    with the Y/Z column flips."""
    if case == "golden":
        raw, replies = frame(golden_message()), [32 * 24 * 3]
        status = dict(num_gaussians=1234, train_params={"Num_Rendered": 99})
    else:
        raw, replies = open(FIXTURE, "rb").read(), [32 * 24 * 3, 0]
        status = dict(num_gaussians=77)
    out = {}
    for name, cls in (("jax", jserver.ViewerServer),
                      ("torch", server.ViewerServer)):
        seen = []
        out[name] = serve(cls, raw, replies, recording_render(seen), status)
        out[name] += (seen,)
    (jb, jp, js), (tb, tp, ts) = out["jax"], out["torch"]
    assert tb == jb and tp == jp
    assert len(ts) == len(js) == 1
    for k in ("wv", "fp", "campos"):
        np.testing.assert_array_equal(ts[0][k], js[0][k])
    assert ts[0]["tan"] == js[0]["tan"] and ts[0]["wh"] == js[0]["wh"]
    status = json.loads(tb[32 * 24 * 3 + 4:32 * 24 * 3 + 4 + int.from_bytes(
        tb[32 * 24 * 3:32 * 24 * 3 + 4], "little")])
    assert status["num_gaussians"] == (1234 if case == "golden" else 77)
    expect = np.asarray(golden_message()["view_matrix"]).reshape(4, 4)
    expect[:, 1:3] *= -1
    np.testing.assert_allclose(ts[0]["wv"], expect, atol=1e-7)


def test_server_drops_a_malformed_request_as_jax_does():
    """A frame whose payload is not JSON: poll_once returns None and drops
    the connection, in both packages."""
    for cls in (jserver.ViewerServer, server.ViewerServer):
        srv = cls(port=0)
        s = socket.create_connection(("127.0.0.1", srv.port))
        s.sendall((5).to_bytes(4, "little") + b"{nope")
        deadline = time.monotonic() + 10.0
        while srv.conn is None and time.monotonic() < deadline:
            srv.try_connect()
        assert srv.poll_once(recording_render([])) is None
        assert srv.conn is None
        s.close()
        srv.close()


@pytest.mark.parametrize("bucket", list(range(len(cli._RES_BUCKETS))))
def test_res_bucket_matches_jax(bucket):
    """Every edge of a bucket, one past it on each axis, and windows past
    the largest bucket round as in the JAX package."""
    assert cli._RES_BUCKETS == jcli._RES_BUCKETS
    bw, bh = cli._RES_BUCKETS[bucket]
    for w, h in ((bw, bh), (bw + 1, bh), (bw, bh + 1), (bw - 1, bh - 1),
                 (1, bh), (bw, 1), (3000, bh), (bw, 3000)):
        assert cli._res_bucket(w, h) == jcli._res_bucket(w, h), (w, h)


# ---- cmd_viewer -------------------------------------------------------------

def tiny_dhier(path):
    """A 48-leaf tree with rotated anisotropic leaves, SH 1, in front of
    the cameras of viewer_requests."""
    rng = np.random.default_rng(3)
    n = 48
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    pts[:, 2] += 4.0
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    h = jhb.build_hierarchy(
        pts, np.exp(rng.normal(size=(n, 3)) * 0.3 - 2.2).astype(np.float32),
        q, rng.uniform(0.4, 0.9, n).astype(np.float32),
        (rng.random((n, 4, 3)).astype(np.float32) - 0.5) * 0.6)
    jdhier.save_dhier(path, jdhier.DHier(
        sh_degree=1, pos=h.pos, quat=h.quat,
        log_scale=np.log(np.maximum(h.scale, 1e-12)).astype(np.float32),
        opacity=np.clip(h.opacity, 1e-4, 1 - 1e-6).astype(np.float32),
        shs=h.sh.astype(np.float32), nodes=h.nodes))


def sibr_message(yaw, x, w, h, **sliders):
    """The request a SIBR client sends for a camera at (x, 0, 0) yawed by
    ``yaw``: the matrices with the Y/Z flips that decode_camera undoes."""
    R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                  [-np.sin(yaw), 0, np.cos(yaw)]])
    cam = jcam.make_camera(R, -R.T @ np.array([x, 0.0, 0.0]), 0.9, 0.7, w, h)
    wv = np.asarray(cam.world_view, np.float64).copy()
    fp = np.asarray(cam.full_proj, np.float64).copy()
    wv[:, 1:3] *= -1
    fp[:, 1] *= -1
    return dict(resolution_x=w, resolution_y=h, fov_x=0.9, fov_y=0.7,
                z_near=0.01, z_far=100.0, train=False, keep_alive=True,
                scaling_modifier=1.0,
                slider=dict({"distance_multiplier": 1.0}, **sliders),
                view_matrix=list(wv.flatten()),
                view_projection_matrix=list(fp.flatten()))


def viewer_requests():
    """The fixture's requests, then realistic views: a plain one, a bigger
    window (another bucket), the SPT false colours, and freeze_view held
    over a moving camera."""
    return fixture_messages() + [
        sibr_message(0.0, 0.0, 40, 30),
        sibr_message(0.1, 0.2, 300, 200),
        sibr_message(-0.1, 0.0, 40, 30, render_SPTs=1),
        sibr_message(0.05, 0.1, 40, 30, freeze_view=1),
        sibr_message(0.2, 0.4, 40, 30, freeze_view=1, granularity=2e-3),
    ]


class StubServer:
    """Stands in for ViewerServer: feeds the requests through
    decode_camera to render_fn, records each frame and the status JSON it
    would send, and interrupts after the last."""

    log = []
    decode = None       # the package's own ViewerServer.decode_camera

    def __init__(self, host="127.0.0.1", port=0):
        self.status = {}
        self.port = 0
        self.requests = viewer_requests()

    def poll_once(self, render_fn):
        if not self.requests:
            raise KeyboardInterrupt
        decoded = type(self).decode(self.requests.pop(0))
        if decoded is None:
            StubServer.log.append(None)
            return {}
        cam, opts = decoded
        img = np.ascontiguousarray(render_fn(cam, opts), dtype=np.uint8)
        status = dict(iteration=99, num_gaussians=0, loss=0, sh_degree=1,
                      error=0, paused=False, train_params={})
        status.update(self.status)
        StubServer.log.append((img, json.dumps(status)))
        return opts

    def close(self):
        StubServer.log.append("closed")


@pytest.fixture(scope="module")
def viewer_runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("viewer") / "tiny.dhier")
    tiny_dhier(path)
    mp = pytest.MonkeyPatch()
    runs = {}
    try:
        for mod in (jserver, server):
            mp.setattr(mod, "ViewerServer", type("Stub", (StubServer,), dict(
                decode=staticmethod(mod.ViewerServer.decode_camera))))
        for name, run in (
                ("jax", lambda a: jcli.cmd_viewer(a)),
                ("torch", lambda a: cli.cmd_viewer(a, device=CPU))):
            StubServer.log = []
            args = argparse.Namespace(
                hierarchy=path, host="127.0.0.1", port=0,
                backend="xla" if name == "jax" else "pallas",
                occlusion_cull=False)
            run(args)
            runs[name] = StubServer.log
    finally:
        mp.undo()
    return runs


def test_cmd_viewer_frames_match_jax(viewer_runs):
    """Every served frame within 1 LSB of the JAX package's, at the
    window's size (rendered at its bucket and sampled back), and the
    interrupt closes the server."""
    j, t = viewer_runs["jax"], viewer_runs["torch"]
    assert len(t) == len(j) == len(viewer_requests()) + 1
    assert t[-1] == j[-1] == "closed"
    n_frames = 0
    for a, b in zip(t[:-1], j[:-1]):
        if b is None:
            assert a is None
            continue
        assert a[0].shape == b[0].shape and a[0].dtype == np.uint8
        diff = np.abs(a[0].astype(np.int16) - b[0].astype(np.int16))
        assert diff.max() <= 1, diff.max()
        n_frames += 1
    assert n_frames == 6
    # the realistic views show the tree; the SPT colours differ from it
    assert t[2][0].std() > 0 and not np.array_equal(t[4][0], t[2][0])


def test_cmd_viewer_status_matches_jax(viewer_runs):
    """The status JSON of every frame equal, the one-frame-lagged active
    count (Num_Rendered) from the second frame on."""
    j, t = viewer_runs["jax"], viewer_runs["torch"]
    statuses = [json.loads(a[1]) for a in t[:-1] if a is not None]
    for a, b in zip(t[:-1], j[:-1]):
        if b is not None:
            assert json.loads(a[1]) == json.loads(b[1])
    assert "Num_Rendered" not in statuses[0]["train_params"]
    assert all(s["train_params"]["Num_Rendered"] > 0 for s in statuses[1:])
