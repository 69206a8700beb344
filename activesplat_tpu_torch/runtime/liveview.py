"""Headless live visualization server (counterpart of
activesplat_tpu/runtime/liveview.py) — the GUI stand-in.

The reference's Open3D GUI (visualizer.py, 2332 LoC) shows the live RGBD
render, the top-down free/visible maps, gaussian count, camera pose and
render timing. On a headless host the same surface is served over HTTP from
a background thread: `/` is a small auto-refreshing dashboard, and
`/view.png`, `/topdown.png`, `/planner.png`, `/subregions.png`,
`/panorama.png`, `/map3d.png` and `/metrics.json` expose the latest
artifacts — the standard library's http.server, the port's PNG encoder
(io/png.py) and colour tables (io/colormaps.py), no effect on the mapping
loop beyond a couple of numpy copies per update. The images' pixels are the
JAX package's (OpenCV's); the PNG bytes are not.

Usage: launch with `--live_view_port 8751` (0 picks a free port) and open
the printed URL; programmatic consumers poll the JSON/PNG endpoints.
"""

from __future__ import annotations

import http.server
import json
import threading
from typing import Dict, Optional

import numpy as np

from activesplat_tpu_torch.io.colormaps import JET_RGB, VIRIDIS_RGB, normalized_u8
from activesplat_tpu_torch.io.png import encode_png

_PAGE = b"""<!doctype html><html><head><title>activesplat_tpu_torch</title>
<style>body{font-family:monospace;background:#111;color:#ddd;margin:20px}
img{image-rendering:pixelated;border:1px solid #444;margin:4px}
pre{color:#8c8}</style></head><body>
<h3>activesplat_tpu_torch live view</h3>
<div><img id=v src="/view.png" height=280>
<img id=t src="/topdown.png" height=280>
<img id=p src="/planner.png" height=280></div>
<div><img id=s src="/subregions.png" height=200>
<img id=o src="/panorama.png" height=200>
<img id=g src="/map3d.png" height=200></div>
<pre id=m></pre>
<script>setInterval(()=>{for(const [i,u] of [['v','view'],['t','topdown'],
['p','planner'],['s','subregions'],['o','panorama'],['g','map3d']])
document.getElementById(i).src='/'+u+'.png?'+Date.now();
fetch('/metrics.json').then(r=>r.json()).then(j=>{
document.getElementById('m').textContent=JSON.stringify(j,null,1)})},1000)
</script></body></html>"""


class LiveView:
    """Thread-safe latest-state store + HTTP server."""

    IMAGES = ("view", "topdown", "planner", "subregions", "panorama", "map3d")

    def __init__(self, port: int = 0):
        self._lock = threading.Lock()
        self._images: Dict[str, bytes] = {}
        self._metrics: Dict = {}
        store = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # silence request logging
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._reply(200, "text/html", _PAGE)
                elif path.endswith(".png") and path[1:-4] in LiveView.IMAGES:
                    self._img(store._get(path[1:-4]))
                elif path == "/metrics.json":
                    with store._lock:
                        body = json.dumps(store._metrics).encode()
                    self._reply(200, "application/json", body)
                else:
                    self._reply(404, "text/plain", b"not found")

            def _img(self, png):
                if png is None:
                    self._reply(404, "text/plain", b"no image yet")
                else:
                    self._reply(200, "image/png", png)

            def _reply(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def _get(self, which: str) -> Optional[bytes]:
        with self._lock:
            return self._images.get(which)

    def _put(self, which: str, img_rgb: np.ndarray) -> None:
        png = encode_png(np.ascontiguousarray(img_rgb))
        with self._lock:
            self._images[which] = png

    # ------------------------------------------------------------------ #
    # producer API (called from the mapper node / planner FSM)

    def update_view(self, rgb: np.ndarray, depth: Optional[np.ndarray] = None):
        """Latest rendered view; rgb float [0,1] or uint8 (H, W, 3)."""
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        img = rgb
        if depth is not None:
            img = np.hstack([img, JET_RGB[normalized_u8(depth)]])
        self._put("view", img)

    def update_topdown(self, free_binary: np.ndarray, unobserved_binary: np.ndarray):
        """Latest planner maps: free (green) over unobserved (gray)."""
        h, w = free_binary.shape
        img = np.zeros((h, w, 3), np.uint8)
        img[unobserved_binary > 0] = (90, 90, 90)
        img[free_binary > 0] = (80, 200, 80)  # the same in RGB and BGR
        self._put("topdown", img)

    def update_planner(self, img_bgr: np.ndarray):
        """Voronoi graph + node scores + planned path + agent overlay,
        pushed by the planner FSM per SELECT_TARGET tick (live counterpart
        of the reference planner's CV2 windows, planner_node.py:1294-1495).
        The planner draws in OpenCV's BGR order."""
        self._put("planner", img_bgr[..., ::-1])

    def update_subregions(self, img_bgr: np.ndarray):
        self._put("subregions", img_bgr[..., ::-1])

    def update_panorama(self, invis: np.ndarray):
        """Latest local-query invisibility panorama (float [0,1]-ish)."""
        self._put("panorama", VIRIDIS_RGB[normalized_u8(invis)])

    def update_map3d(self, rgb: np.ndarray):
        """Latest orbit render of the live Gaussian map (trajectory overlay
        baked in by the producer) — the headless counterpart of the
        reference GUI's 3D map widget (visualizer.py:1515-1664)."""
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        self._put("map3d", rgb)

    def update_metrics(self, metrics: Dict):
        with self._lock:
            self._metrics = dict(metrics)

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
