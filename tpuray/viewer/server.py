"""Interactive viewer: a render thread + a threaded HTTP server.

Equivalent of the reference's interactive layer — the GLFW frame
loop and input callbacks (main.cpp:345-603, 614-663) and the imgui parameter
/ debug-view windows (main.cpp:363-431) — redesigned for remote GPU hosts:
the device renders, a stdlib HTTP server streams PNG frames to any browser,
and control events (orbit / dolly / pan / sliders / debug view) come back as
JSON. Any camera or parameter change resets temporal accumulation, exactly
like the reference's frameCounter=0 on slider/camera change
(main.cpp:372-387, Utils/camera.h:62-74).

Usage: python -m tpuray.cli.main view --scene reference --size 400
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import fields
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

import numpy as np

from tpuray.io.image import encode_png
from tpuray.render.renderer import Renderer, select_debug_view, tonemap
from tpuray.scene.camera import OrbitCamera
from tpuray.scene.config import DebugView, RenderConfig
from tpuray.viewer.ui import render_page

_CFG_FIELDS = {f.name: f.type for f in fields(RenderConfig)}
# params the UI may set (the imgui-exposed subset, main.cpp:372-387)
_UI_PARAMS = {
    "max_tracing_depth": int, "num_atrous_iterations": int,
    "sigma_n": float, "sigma_l": float,
    "reproj_depth_threshold": float, "reproj_normal_threshold": float,
    "clamp_threshold": float, "accumulate": bool, "use_normal_map": bool,
}


class ViewerServer:
    """Owns the Renderer + OrbitCamera; applies control events between
    frames; publishes (seq, png bytes, stats) to the HTTP handlers."""

    def __init__(self, scene, cfg: RenderConfig, host: str = "127.0.0.1",
                 port: int = 8008, max_fps: float = 60.0):
        self.renderer = Renderer(scene, cfg)
        self.camera = OrbitCamera(width=cfg.width, height=cfg.height)
        self.view = DebugView.FINAL
        self.host, self.port = host, port
        self.max_fps = max_fps
        self._events: list[dict] = []
        self._lock = threading.Lock()          # guards _events
        self._pub = threading.Condition()      # guards seq/png/stats
        self.seq = 0
        self.png: bytes = b""
        self.stats: dict = {}
        self._stop = threading.Event()
        self._httpd: ThreadingHTTPServer | None = None
        self._threads: list[threading.Thread] = []

    # ---- control ----
    def submit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def _apply_events(self) -> None:
        with self._lock:
            evs, self._events = self._events, []
        dirty = False
        for ev in evs:
            t = ev.get("type")
            if t == "rotate":
                self.camera.rotate(float(ev["dx"]), float(ev["dy"]))
                dirty = True
            elif t == "dolly":
                self.camera.dolly(float(ev["d"]))
                dirty = True
            elif t == "pan":
                self.camera.pan_by(float(ev.get("forward", 0.0)),
                                   float(ev.get("right", 0.0)))
                dirty = True
            elif t == "param":
                name = ev.get("name")
                if name in _UI_PARAMS:
                    val = _UI_PARAMS[name](ev["value"])
                    self.renderer.cfg = self.renderer.cfg.replace(**{name: val})
                    dirty = True
            elif t == "view":
                try:
                    self.view = DebugView(int(ev["view"]))
                except ValueError:
                    pass
            elif t == "reset":
                dirty = True
        if dirty:
            # any parameter/camera change restarts temporal accumulation
            self.renderer.reset()

    # ---- render loop ----
    def _render_loop(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            self._apply_events()
            out = self.renderer.step(self.camera.snapshot())
            img = np.asarray(tonemap(select_debug_view(out, self.view),
                                     self.renderer.cfg.tonemap_limit,
                                     self.renderer.cfg.gamma))
            png = encode_png(img, compress_level=1)
            dt = time.perf_counter() - t0
            stats = {
                "text": (f"frame {int(self.renderer.state.frame_idx)}"
                         f"  |  {dt * 1e3:.1f} ms/frame ({1.0 / max(dt, 1e-9):.1f} fps)"
                         f"\nview: {self.view.name.lower()}"
                         f"  depth={self.renderer.cfg.max_tracing_depth}"
                         f" atrous={self.renderer.cfg.num_atrous_iterations}"),
                "ms": dt * 1e3,
                "frame": int(self.renderer.state.frame_idx),
            }
            with self._pub:
                self.seq += 1
                self.png = png
                self.stats = stats
                self._pub.notify_all()
            budget = 1.0 / self.max_fps - (time.perf_counter() - t0)
            if budget > 0:
                self._stop.wait(budget)

    def wait_frame(self, after_seq: int, timeout: float = 25.0):
        """Block until a frame newer than after_seq exists (long poll)."""
        after_seq = max(after_seq, 0)  # seq 0 == "no frame published yet"
        deadline = time.monotonic() + timeout
        with self._pub:
            while self.seq <= after_seq and not self._stop.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._pub.wait(remaining)
            if self.seq <= after_seq:
                return None
            return self.seq, self.png, self.stats

    def state_json(self) -> bytes:
        cfg = self.renderer.cfg
        params = {k: getattr(cfg, k) for k in _UI_PARAMS}
        return json.dumps({
            "params": params, "view": int(self.view),
            "width": cfg.width, "height": cfg.height,
            "camera": {"yaw": self.camera.yaw_deg,
                       "pitch": self.camera.pitch_deg,
                       "radius": self.camera.radius},
        }).encode()

    # ---- lifecycle ----
    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str,
                      headers: dict | None = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    self._send(200, render_page().encode(), "text/html")
                elif url.path == "/frame.png":
                    q = parse_qs(url.query)
                    after = int(q.get("seq", ["-1"])[0])
                    got = server.wait_frame(after)
                    if got is None:
                        self._send(204, b"", "text/plain")
                        return
                    seq, png, stats = got
                    self._send(200, png, "image/png", {
                        "X-Seq": str(seq), "X-Stats": json.dumps(stats)})
                elif url.path == "/state":
                    self._send(200, server.state_json(), "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if urlparse(self.path).path != "/control":
                    self._send(404, b"not found", "text/plain")
                    return
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    ev = json.loads(self.rfile.read(n) or b"{}")
                    server.submit(ev)
                    self._send(200, b'{"ok":true}', "application/json")
                except (json.JSONDecodeError, KeyError):
                    self._send(400, b'{"ok":false}', "application/json")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port=0
        for target in (self._render_loop, self._httpd.serve_forever):
            th = threading.Thread(target=target, daemon=True)
            th.start()
            self._threads.append(th)

    def stop(self) -> None:
        self._stop.set()
        with self._pub:
            self._pub.notify_all()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for th in self._threads:
            th.join(timeout=10.0)

    def serve_forever(self) -> None:
        print(f"tpuray viewer: http://{self.host}:{self.port}/", flush=True)
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            self.stop()
