"""Live detection streaming — the interactive observability surface.

The reference streams every intermediate to a rerun.io viewer while
detecting (aprilgrid-rs examples/demo.rs:101-120 and
examples/develop.rs:147-173: image, refined saddles, tag corners, decode
sample points, all on a shared timeline). rerun is not available here, so
this module provides the equivalent live surface with no extra
dependencies: an in-process HTTP server that pushes overlay frames (drawn
by ``viz.render_overlay``) as an MJPEG stream to any browser (plus
single-frame and JSON state endpoints for headless consumers), fed by
``LiveStream.publish`` from the detection loop.

Endpoints:
  /            viewer page (layer legend, live <img> of the stream)
  /stream.mjpg multipart/x-mixed-replace MJPEG of the overlay frames
  /latest.jpg  most recent overlay frame (single shot)
  /state.json  frame counter + last detection summary (ids, counts)

Usage:
    stream = LiveStream(port=8000)
    stream.start()
    try:
        for img in frames:
            tags = detector.detect(img)
            stream.publish(img, tags=tags,
                           saddles=detector.refined_saddle_points(img))
    finally:
        stream.stop()
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .viz import render_overlay

_PAGE = """<!doctype html>
<html><head><title>aprilgrid-tpu live</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:1em }
img { max-width:100%%; border:1px solid #444 }
.legend span { margin-right:1.5em }
</style></head><body>
<h3>aprilgrid-tpu live detection stream</h3>
<div class="legend">
<span style="color:#ffdc00">&#9585; saddles</span>
<span style="color:#7fdbff">&#9633; tag corners + ids</span>
<span style="color:#ff851b">&middot; decode samples</span>
</div>
<p><img src="/stream.mjpg" alt="live stream"></p>
<p id="state"></p>
<script>
setInterval(async () => {
  const r = await fetch('/state.json');
  document.getElementById('state').textContent = await r.text();
}, 500);
</script>
</body></html>"""


class LiveStream:
    """Threaded MJPEG publisher for live detection overlays."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 quality: int = 85):
        self._lock = threading.Condition()
        self._jpeg: bytes | None = None
        self._state: dict = {"frame": 0}
        self._quality = quality
        self._server = ThreadingHTTPServer(
            (host, port), self._make_handler()
        )
        self._thread: threading.Thread | None = None

    # -- public API ------------------------------------------------------
    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "LiveStream":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def publish(
        self,
        img: np.ndarray,
        tags: dict | None = None,
        saddles=None,
        decode_points: dict | None = None,
    ) -> None:
        """Render the overlay layers onto ``img`` and push the frame to
        every connected stream (same layers the reference streams to
        rerun: saddles with orientation ticks, tag corners with per-id
        colors, decode sample points)."""
        from PIL import Image

        overlay = render_overlay(
            img, tags=tags, saddles=saddles, decode_points=decode_points
        )
        buf = io.BytesIO()
        Image.fromarray(overlay).save(buf, "JPEG", quality=self._quality)
        with self._lock:
            self._jpeg = buf.getvalue()
            self._state = {
                "frame": self._state["frame"] + 1,
                "tags": sorted(tags) if tags else [],
                "n_tags": len(tags or ()),
                "n_saddles": len(saddles or ()),
            }
            self._lock.notify_all()

    # -- HTTP ------------------------------------------------------------
    def _make_handler(self):
        stream = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/latest.jpg":
                    with stream._lock:
                        jpeg = stream._jpeg
                    if jpeg is None:
                        self.send_error(404, "no frame published yet")
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpeg)))
                    self.end_headers()
                    self.wfile.write(jpeg)
                elif self.path == "/state.json":
                    with stream._lock:
                        body = json.dumps(stream._state).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stream.mjpg":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    last = -1
                    try:
                        while True:
                            with stream._lock:
                                if stream._state["frame"] == last:
                                    # wake on publish; timeout keeps the
                                    # socket write loop responsive to
                                    # client disconnects
                                    stream._lock.wait(timeout=1.0)
                                jpeg = stream._jpeg
                                last = stream._state["frame"]
                            if jpeg is None:
                                continue
                            self.wfile.write(b"--frame\r\n")
                            self.wfile.write(
                                b"Content-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(jpeg)}\r\n"
                                  .encode()
                                + b"\r\n"
                            )
                            self.wfile.write(jpeg)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        return
                else:
                    self.send_error(404)

        return Handler
