"""Interactive viewer server (cli/serve.py): handlers + HTTP round trip.

The reference app's interactive window (SURVEY.md C2/C8/L5) maps to a
localhost HTTP fly-camera; this drives it end-to-end on the CPU with a
tiny scene.
"""

import io
import json
import math
import threading
import urllib.request

import numpy as np
import pytest

import hmrt as H
from hmrt.cli.serve import ViewerSession, make_handler
from hmrt.io.image import read_png


@pytest.fixture(scope="module")
def session():
    terr = H.procedural_terrain(64, seed=3)
    scene = H.make_scene(terr)
    cfg = H.RenderConfig(width=96, height=64)
    n = terr.shape[0]
    return ViewerSession(scene, cfg,
                         eye=(n * 0.5, -n * 0.2, float(terr.max()) + 6.0),
                         yaw=math.pi / 2, pitch=-0.2, speed=1.0,
                         draft_scale=2)


def _decode(png_bytes):
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".png") as f:
        f.write(png_bytes)
        f.flush()
        return read_png(f.name)


def test_render_frame_png(session):
    params = json.loads(session.state_json())
    png = session.render_frame_png(params)
    img = _decode(png)
    assert img.shape == (64, 96, 3)
    assert img.max() > 0

    params["draft"] = True
    draft = _decode(session.render_frame_png(params))
    # draft floors: width >= 64, height >= 36 (serve.ViewerSession)
    assert draft.shape == (36, 64, 3)


def test_http_round_trip(session):
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(session))
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        page = urllib.request.urlopen(base + "/", timeout=30).read()
        assert b"hmrt viewer" in page
        state = json.loads(
            urllib.request.urlopen(base + "/state", timeout=30).read())
        assert len(state["eye"]) == 3
        body = json.dumps({"eye": state["eye"], "yaw": state["yaw"],
                           "pitch": state["pitch"], "draft": True}).encode()
        req = urllib.request.Request(base + "/frame", data=body,
                                     method="POST")
        resp = urllib.request.urlopen(req, timeout=120)
        assert resp.headers["Content-Type"] == "image/png"
        img = _decode(resp.read())
        assert img.shape == (36, 64, 3)
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_bad_requests(session):
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(session))
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nope", timeout=30)
        assert e.value.code == 404
        req = urllib.request.Request(base + "/frame", data=b"not json",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 500
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_tiled_viewer_session():
    """Out-of-core viewer mode: frames stream through api.tiled with the
    scene cache; pixels match the resident session's render."""
    from hmrt.api.tiled import TileSceneCache

    terr = H.procedural_terrain(65, seed=3)
    cfg = H.RenderConfig(width=96, height=64)
    n = terr.shape[0]
    eye = (n * 0.5, -n * 0.2, float(terr.max()) + 6.0)
    cache = TileSceneCache(8)
    tiled = ViewerSession(None, cfg, eye=eye, yaw=math.pi / 2, pitch=-0.2,
                          speed=1.0, tiled=(terr, 32, cache))
    resident = ViewerSession(H.make_scene(terr), cfg, eye=eye,
                             yaw=math.pi / 2, pitch=-0.2, speed=1.0)
    params = json.loads(tiled.state_json())
    a = _decode(tiled.render_frame_png(params))
    b = _decode(resident.render_frame_png(params))
    assert a.shape == (64, 96, 3)
    # 8-bit quantized output: tiled-vs-monolithic float wiggle is < 1 LSB
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
    assert cache.built > 0
    before = cache.built
    tiled.render_frame_png(params)  # second frame: warm cache
    assert cache.built == before
