"""Live web viewer (port of sdslam_tpu/viewer_server.py): the interactive
counterpart of the headless renderer, a stdlib HTTP server any browser can
watch while the CLI or a StreamRunner tracks:

    GET /            auto-refreshing HTML dashboard
    GET /map.png     top-down map render (viewer.draw_map)
    GET /frame.png   current frame with its keypoints (viewer.draw_frame)
    GET /ar.png      AR overlay (cube and grid on each detected plane)
    GET /status.json tracking state, keyframe / point counts, frames
    POST /reset                 -> queue System.reset()     (menu "Reset")
    POST /localization/<on|off> -> queue the localization toggle
    POST /plane/add             -> queue an AR plane detection
    POST /plane/clear           -> clear the AR planes
    POST /stop_save             -> request stop and save

The menu actions follow the reference's Pangolin buttons and their deferred
application (Viewer::CheckMenu): a POST only queues an action, and the
thread that owns the tracking loop applies it at a frame boundary
(`apply_pending`, called from SDSlamSystem._after_frame). Applying it on the
handler thread would race the tracker, which replaces its map and state
while a frame is in flight.

Renders and `status()` run on the handler thread: their host copies wait for
the work queued on the map's stream, which blocks the handler, not the
tracker, and a render holds only the render cache's lock, never the action
queue's. Renders hold the interpreter lock while matplotlib draws, so they
are throttled (`min_render_interval`). A plane detection never waits on the
tracking thread: `plane_add` clones the points on the current stream,
copies them into pinned host memory without blocking and records an event;
a later frame boundary runs the RANSAC once `event.query()` reports the
copies done. CPU tensors and numpy arrays are ready at once.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from sdslam_tpu_torch import viewer as V
from sdslam_tpu_torch.viewer import _host

_PAGE = """<!doctype html>
<html><head><title>sdslam_tpu_torch live viewer</title>
<style>
 body {{ background:#111; color:#ddd; font-family:monospace; }}
 img {{ border:1px solid #444; max-width:48%; }}
 button {{ background:#333; color:#ddd; border:1px solid #666;
          padding:4px 10px; margin-right:8px; }}
</style></head>
<body>
<h3>sdslam_tpu_torch</h3>
<div id="status">connecting...</div>
<p>
 <button onclick="fetch('/reset',{{method:'POST'}})">Reset</button>
 <button onclick="fetch('/localization/on',{{method:'POST'}})">Localization on</button>
 <button onclick="fetch('/localization/off',{{method:'POST'}})">Localization off</button>
 <button onclick="fetch('/plane/add',{{method:'POST'}})">Add AR plane</button>
 <button onclick="fetch('/plane/clear',{{method:'POST'}})">Clear planes</button>
 <button onclick="fetch('/stop_save',{{method:'POST'}})">Stop and Save</button>
</p>
<img id="map" src="/map.png"> <img id="frame" src="/frame.png">
<script>
 setInterval(() => {{
   fetch('/status.json').then(r => r.json()).then(s => {{
     document.getElementById('status').textContent = JSON.stringify(s);
   }});
   document.getElementById('map').src = '/map.png?' + Date.now();
   document.getElementById('frame').src = '/frame.png?' + Date.now();
 }}, {refresh_ms});
</script>
</body></html>
"""

_ACTIONS = {
    "/reset": "reset",
    "/localization/on": "localization_on",
    "/localization/off": "localization_off",
    "/plane/add": "plane_add",
    "/plane/clear": "plane_clear",
    "/stop_save": "stop_save",
}


class _StagedCopy:
    """A snapshot of the map's points on its way to the host."""

    def __init__(self, pos, valid):
        if isinstance(pos, torch.Tensor) and pos.is_cuda:
            # clone on the current stream: ordered before any later in-place
            # write to the map there; the copies land in pinned memory
            self.pos = torch.empty(pos.shape, dtype=pos.dtype, pin_memory=True)
            self.valid = torch.empty(valid.shape, dtype=valid.dtype, pin_memory=True)
            self.pos.copy_(pos.clone(), non_blocking=True)
            self.valid.copy_(valid.clone(), non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.pos = pos.clone() if isinstance(pos, torch.Tensor) else np.array(pos)
            self.valid = valid.clone() if isinstance(valid, torch.Tensor) else np.array(valid)
            self.event = None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def points(self) -> np.ndarray:
        return np.asarray(self.pos)[np.asarray(self.valid)]


class LiveViewer:
    """Serve a live view of a running SDSlamSystem.

    system: SDSlamSystem, or any object with .tracker, .reset(),
    .activate_localization_mode(), .deactivate_localization_mode() and
    .request_stop(). min_render_interval throttles the matplotlib renders
    so the viewer does not compete with the tracking loop for the host.
    """

    def __init__(self, system, min_render_interval: float = 0.5, refresh_ms: int = 1000):
        self.system = system
        self.refresh_ms = refresh_ms
        self._min_dt = float(min_render_interval)
        self._lock = threading.Lock()  # the action queue
        # the render cache; reentrant: /ar.png without planes serves /frame.png.
        # A render never holds the queue's lock, so apply_pending never waits
        # on one
        self._render_lock = threading.RLock()
        self._cache = {}  # path -> (t, bytes)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._actions: list = []  # queued by the handlers, applied by apply_pending
        self.planes: list = []  # detected AR planes: {"plane": (n, d, inliers), "points"}
        self._staged_planes: list = []  # _StagedCopy, finished at a later boundary
        # the tracking side polls this viewer (SDSlamSystem._after_frame)
        system._live_viewer = self

    # -- queued menu actions -----------------------------------------------

    def request(self, action: str):
        """Queue a menu action for the owning tracking loop."""
        with self._lock:
            self._actions.append(action)

    def apply_pending(self):
        """Apply the queued menu actions. Call it only from the thread that
        owns the tracking loop, at a frame boundary. Returns the actions."""
        with self._lock:
            actions, self._actions = self._actions, []
        for a in actions:
            if a == "reset":
                self.system.reset()
                self.system._live_viewer = self
                self.planes.clear()
            elif a == "localization_on":
                self.system.activate_localization_mode()
            elif a == "localization_off":
                self.system.deactivate_localization_mode()
            elif a == "plane_add":
                ms = self.system.tracker.ms
                self._staged_planes.append(_StagedCopy(ms.pt_pos, ms.pt_valid))
            elif a == "plane_clear":
                self.planes.clear()
                self._staged_planes.clear()
            elif a == "stop_save":
                # System::RequestStop: the front-end loop stops at this
                # boundary and saves
                self.system.request_stop()
        self._finish_planes()
        return actions

    def _finish_planes(self):
        """Run the plane RANSAC for every staged copy that has landed."""
        still = []
        for staged in self._staged_planes:
            if not staged.ready():
                still.append(staged)
                continue
            pts = staged.points()
            res = V.detect_plane(pts, seed=len(self.planes))
            if res is not None:
                # the inlier mask indexes this snapshot, and draw_ar anchors
                # the grid on the inlier centroid
                self.planes.append({"plane": res, "points": pts})
        self._staged_planes = still

    # -- renders --------------------------------------------------------------

    def map_png(self) -> bytes:
        tr = self.system.tracker
        buf = io.BytesIO()
        V.draw_map(tr.ms, trajectory=[p for p in tr.trajectory if p is not None], path=buf)
        return buf.getvalue()

    def frame_png(self) -> bytes:
        fr = self.system.tracker.st.last_frame
        buf = io.BytesIO()
        if fr is None:
            plt, (fig, ax) = V._figure()
            ax.text(0.5, 0.5, "no frames yet", ha="center")
            fig.savefig(buf, format="png", dpi=80)
            plt.close(fig)
            return buf.getvalue()
        f = fr.features
        V.draw_frame(_host(fr.pyramid[0]), _host(f.uv)[_host(f.valid)],
                          state_text=self.status()["state"], path=buf)
        return buf.getvalue()

    def ar_png(self) -> bytes:
        """AR overlay on the current frame: a cube and a grid per detected
        plane (FrameDrawer::DrawCube / DrawPlane)."""
        from PIL import Image

        tr = self.system.tracker
        fr = tr.st.last_frame
        if fr is None or not self.planes:
            return self._cached("frame", self.frame_png)
        arr = _host(fr.pyramid[0])
        Tcw = _host(tr.st.T_last)
        for p in self.planes:
            arr = V.draw_ar(arr, self.system.config.camera, Tcw, p["plane"], points=p["points"])
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "PNG")
        return buf.getvalue()

    def status(self) -> dict:
        tr = self.system.tracker
        return {
            "state": tr.st.status,
            "keyframes": int(_host(tr.ms.kf_valid).sum()),
            "points": int(_host(tr.ms.pt_valid).sum()),
            "frames": len(tr.trajectory),
            "localization_only": bool(getattr(self.system, "localization_only", False)),
            "planes": len(self.planes),
            "pending_actions": len(self._actions) + len(self._staged_planes),
            "stop_requested": bool(getattr(self.system, "stop_requested", False)),
        }

    def _cached(self, key: str, producer) -> bytes:
        with self._render_lock:
            t, data = self._cache.get(key, (0.0, None))
            if data is not None and time.monotonic() - t < self._min_dt:
                return data
            data = producer()
            self._cache[key] = (time.monotonic(), data)
            return data

    # -- http -----------------------------------------------------------------

    def _handler(self):
        viewer = self
        pngs = {"/map.png": ("map", viewer.map_png), "/frame.png": ("frame", viewer.frame_png),
                "/ar.png": ("ar", viewer.ar_png)}

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                try:
                    if path == "/":
                        page = _PAGE.format(refresh_ms=viewer.refresh_ms)
                        self._send(200, "text/html", page.encode())
                    elif path in pngs:
                        self._send(200, "image/png", viewer._cached(*pngs[path]))
                    elif path == "/status.json":
                        self._send(200, "application/json", json.dumps(viewer.status()).encode())
                    else:
                        self._send(404, "text/plain", b"not found")
                except Exception as e:  # a failed render answers 500 with its error
                    self._send(500, "text/plain", f"{type(e).__name__}: {e}".encode())

            def do_POST(self):
                a = _ACTIONS.get(self.path)
                if a is None:
                    self._send(404, "text/plain", b"not found")
                else:
                    viewer.request(a)
                    self._send(200, "text/plain", b"queued")

        return Handler

    def start(self, port: int = 8580, host: str = "127.0.0.1"):
        """Serve from a daemon thread; returns the bound port."""
        self._server = ThreadingHTTPServer((host, port), self._handler())
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self._server.server_address[1]

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
