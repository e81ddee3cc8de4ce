"""The port's live map viewer (rgbd360_torch/utils/live_viewer.py, a copy of
rgbd360_tpu/utils/live_viewer.py) and the --live-view flag of its SLAM apps:
the four cases of tests/test_live_viewer.py on the port, plus the port's
kf_sphere_slam --device cpu over a 3-frame tools/synthetic_rig.py
sequence, fetched over loopback while the app runs. Every viewer is closed
in ``finally``: no daemon server outlives its test."""

import json
import os
import types
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from rgbd360_torch.apps import kf_sphere_slam  # noqa: E402
from rgbd360_torch.apps import sphere_graph_slam  # noqa: E402
from rgbd360_torch.core.map360 import Map360  # noqa: E402
from rgbd360_torch.utils import live_viewer  # noqa: E402
from rgbd360_torch.utils.live_viewer import LiveMapViewer  # noqa: E402
from rgbd360_torch.utils.map_html import build_map_data, render_html  # noqa: E402
from tools import synthetic_rig as rig  # noqa: E402


def _world(n):
    w = Map360()
    for k in range(n):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 0.3 * k
        w.add_keyframe(types.SimpleNamespace(planes=None), pose)
        if k:
            w.add_connection(k - 1, k, np.eye(4, dtype=np.float32), np.eye(6, dtype=np.float32))
    if n >= 4:  # one non-consecutive connection -> an LC edge in the payload
        w.add_connection(0, n - 1, np.eye(4, dtype=np.float32), np.eye(6, dtype=np.float32))
    return w


def _fetch_json(url):
    return json.loads(urllib.request.urlopen(url.replace("live.html", "live.json"), timeout=10).read())


def test_live_viewer_serves_and_updates(tmp_path):
    viewer = LiveMapViewer(str(tmp_path), port=0, interval_ms=500)
    try:
        url = viewer.url
        assert url and url.startswith("http://127.0.0.1:") and url.endswith("/live.html")
        html = urllib.request.urlopen(url, timeout=10).read().decode()
        # live mode is baked in: polls live.json, freeze key handler present
        assert "live.json" in html and "const LIVE=true" in html
        assert "__LIVE__" not in html and "__INTERVAL_MS__" not in html
        assert "'k'" in html or '"k"' in html  # bFreezeFrame analogue
        assert _fetch_json(url)["traj"] == []  # before the first keyframe
        viewer.update(_world(3))
        d = _fetch_json(url)
        assert len(d["traj"]) == 3 and len(d["frusta"]) == 3 * 8
        viewer.update(_world(6))
        d = _fetch_json(url)
        assert len(d["traj"]) == 6
        assert len(d["lc"]) == 1  # the 0 -> n-1 loop-closure edge
    finally:
        viewer.close()
    assert viewer.server is None


def test_live_viewer_files_only_mode(tmp_path):
    viewer = LiveMapViewer(str(tmp_path), port=None)
    try:
        assert viewer.url is None and viewer.server is None
        viewer.update(_world(2))
        d = json.loads((tmp_path / "live.json").read_text())
        assert len(d["traj"]) == 2
        assert not (tmp_path / "live.json.tmp").exists()  # replaced atomically
    finally:
        viewer.close()


def test_offline_render_stays_static():
    html = render_html(build_map_data(trajectory=[np.eye(4)]), "t")
    assert "const LIVE=false" in html
    assert "__DATA__" not in html


@pytest.mark.parametrize("app", ["kf_sphere_slam", "sphere_graph_slam"])
def test_slam_app_live_flag(tmp_path, monkeypatch, app):
    """--live-view on the port's SLAM apps (--device cpu) over 3 frames:
    live.json is fetched over loopback at each update while the app runs,
    and after it holds one trajectory entry per keyframe of the map."""
    d = str(tmp_path)
    rts = rig.write_calib_root(os.path.join(d, "calib"))
    rig.write_sequence(os.path.join(d, "seq"), rts, frames=3, loops=0.05)
    fetched, closed = [], []
    real_update, real_close = LiveMapViewer.update, LiveMapViewer.close

    def update(self, world):
        real_update(self, world)
        fetched.append(len(_fetch_json(self.url)["traj"]))

    def close(self):
        closed.append(self.url)
        real_close(self)

    monkeypatch.setattr(live_viewer.LiveMapViewer, "update", update)
    monkeypatch.setattr(live_viewer.LiveMapViewer, "close", close)
    live = tmp_path / "live"
    argv = [os.path.join(d, "seq"), "--calib-root", os.path.join(d, "calib"), "--device", "cpu",
            "--live-view", str(live), "--live-port", "0"]
    if app == "kf_sphere_slam":
        n_keyframes = len(kf_sphere_slam.run(argv).world)
    else:
        n_keyframes = len(sphere_graph_slam.run(argv).world)
    assert len(closed) == 1 and closed[0].startswith("http://127.0.0.1:")
    assert fetched and fetched[-1] == n_keyframes >= 1
    assert fetched == sorted(fetched)  # the map only grows
    payload = json.loads((live / "live.json").read_text())
    assert len(payload["traj"]) == n_keyframes
    assert "const LIVE=true" in (live / "live.html").read_text()
