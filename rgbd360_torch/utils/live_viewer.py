"""Copy of rgbd360_tpu/utils/live_viewer.py (host only: the payload is
utils/map_html.py's, which reads a keyframe cloud held as tensors back
to the host).

Live map viewer — the running-session analogue of the reference's PCL
visualizer thread (reference include/Map360_Visualizer.h:95-319: a render
thread redrawing the map as the SLAM loop mutates it, with keyboard
toggles; :319-334 keyboardEventOccurred — 'k' freeze, 'l' graph-SLAM
poses, 'n' viz mode).

Headless environments have no GUI stack, so the live experience is served
over HTTP instead: `LiveMapViewer` writes `live.html` once (the same
self-contained canvas viewer as utils/map_html.py, in live mode: it polls
`live.json` and redraws without losing the camera), rewrites `live.json`
atomically on every `update(world)`, and serves the directory from a
daemon-thread HTTP server. Keyboard parity: 'k' freezes the feed
(bFreezeFrame), 'o' toggles optimized-vs-raw trajectories (the reference's
'l'/bGraphSLAM), and the t/f/p/l/c element toggles stand in for the 'n'
mode cycle.
"""

from __future__ import annotations

import json
import os
import threading
from functools import partial
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from rgbd360_torch.utils.map_html import build_map_data, map_view_kwargs, render_html


class _QuietHandler(SimpleHTTPRequestHandler):
    def log_message(self, fmt, *args):  # no per-request stdout spam
        pass


class LiveMapViewer:
    def __init__(
        self,
        out_dir: str,
        port: Optional[int] = 0,  # 0 = ephemeral; None = files only
        interval_ms: int = 2000,
        cloud_stride: int = 0,
        title: str = "rgbd360 live map",
    ):
        self.out_dir = out_dir
        self.cloud_stride = cloud_stride
        self.title = title
        os.makedirs(out_dir, exist_ok=True)
        self.json_path = os.path.join(out_dir, "live.json")
        self.html_path = os.path.join(out_dir, "live.html")
        with open(self.html_path, "w") as f:
            f.write(render_html(build_map_data(title=title), title, live_interval_ms=interval_ms))
        self._write_json(build_map_data(title=title))
        self.server: Optional[ThreadingHTTPServer] = None
        self.port: Optional[int] = None
        if port is not None:
            handler = partial(_QuietHandler, directory=out_dir)
            self.server = ThreadingHTTPServer(("127.0.0.1", port), handler)
            self.port = self.server.server_address[1]
            threading.Thread(
                target=self.server.serve_forever, daemon=True, name="LiveMapViewer"
            ).start()

    def _write_json(self, data: dict) -> None:
        tmp = self.json_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, separators=(",", ":"))
        os.replace(tmp, self.json_path)  # atomic: a poll never sees a torn file

    def update(self, world) -> None:
        """Publish the current map state (call whenever a keyframe lands —
        cheap: hull/trajectory payload only unless cloud_stride > 0)."""
        self._write_json(
            build_map_data(title=self.title, **map_view_kwargs(world, self.cloud_stride))
        )

    @property
    def url(self) -> Optional[str]:
        return f"http://127.0.0.1:{self.port}/live.html" if self.port is not None else None

    def close(self) -> None:
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None
