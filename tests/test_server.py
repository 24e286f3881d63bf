"""HTTP server surface: pages, config, controls, PNG frames, and the binary
position stream for the WebGL view."""

import json
import threading
import urllib.request

import numpy as np
import pytest

from http.server import ThreadingHTTPServer

from particle3d.app.driver import SimulationApp
from particle3d.app.server import _Handler


@pytest.fixture(scope="module")
def server_url():
    app = SimulationApp(n=64)
    _Handler.app = app
    _Handler.lock = threading.Lock()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.read(), r.headers.get("Content-Type")


def test_pages(server_url):
    body, ctype = _get(server_url + "/")
    assert ctype == "text/html" and b"particle3d" in body
    assert b"/gl" in body  # cross-link to the WebGL view
    body, ctype = _get(server_url + "/gl")
    assert ctype == "text/html"
    assert b"webgl2" in body and b"positions.bin" in body


def test_positions_bin_layout(server_url):
    body, ctype = _get(server_url + "/positions.bin")
    assert ctype == "application/octet-stream"
    n = int(np.frombuffer(body[:4], np.int32)[0])
    w = float(np.frombuffer(body[4:8], np.float32)[0])
    assert n == 64 and w == pytest.approx(10.0)
    assert len(body) == 8 + n * 12 + n
    pos = np.frombuffer(body[8:8 + n * 12], np.float32).reshape(n, 3)
    spec = np.frombuffer(body[8 + n * 12:], np.uint8)
    assert np.abs(pos).max() <= w / 2 + 1e-5
    assert spec.max() < 5
    # each request ticks the simulation
    b2, _ = _get(server_url + "/positions.bin")
    m, _ = _get(server_url + "/metrics")
    assert json.loads(m)["step_index"] >= 0


def test_control_and_frame(server_url):
    req = urllib.request.Request(
        server_url + "/control",
        data=json.dumps({"name": "set_drag", "args": {"value": 0.5}}).encode(),
        method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert json.loads(r.read())["ok"]
    body, ctype = _get(server_url + "/frame.png?w=160&h=120")
    assert ctype == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n"
