"""Interactive browser viewer (port of nr3d_lib_tpu/viewer.py).

A single-page orbit UI in the browser (drag = orbit, wheel = dolly, a
layer dropdown, sliders for scene conditions, an overlay box) asks a
small threaded HTTP server for frames; each frame is one render of the
model through `gui.NeuralRenderer` (`model.ray_test`/`ray_query`, on the
model's device), encoded as PNG in memory by the port's own encoder.
Rendering is serialised behind a lock (one model, one card).

Usage::

    from nr3d_lib_tpu_torch.viewer import InteractiveViewer
    v = InteractiveViewer(model, hw=(256, 256))
    url = v.start()            # e.g. http://0.0.0.0:8123
    ...
    v.stop()

Dynamic or conditional scenes take `controls`, sliders whose values go
to every ray of the frame::

    InteractiveViewer(emernerf_model, controls={
        "ts": {"min": -1, "max": 1, "step": 0.05, "value": 0.0}})

`overlays` are `gui_datalayers` line sets (occupancy grid, forest
blocks, frusta) painted over the frame when the page's overlay box is
ticked.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from nr3d_lib_tpu_torch.utils import encode_png, to_numpy

__all__ = ["InteractiveViewer"]

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>nr3d_lib_tpu_torch viewer</title>
<style>
 body{margin:0;background:#14141a;color:#cfcfe0;font:13px sans-serif;
      display:flex;flex-direction:column;align-items:center}
 #bar{padding:6px}  img{image-rendering:pixelated;cursor:grab}
 select,button{background:#22222c;color:#cfcfe0;border:1px solid #444}
</style></head><body>
<div id="bar">layer <select id="layer"></select>
 <label><input type="checkbox" id="ov">overlay</label>
 <span id="ctrls"></span> <span id="stat"></span></div>
<img id="view" width=512 height=512>
<script>
let th=0.6, ph=0.35, r=3.0, busy=false, dirty=true;
const img=document.getElementById('view'), sel=document.getElementById('layer');
const stat=document.getElementById('stat'), ctrls={};
document.getElementById('ov').onchange=()=>{dirty=true;};
fetch('layers').then(r=>r.json()).then(ls=>{
  for(const l of ls){const o=document.createElement('option');
    o.value=o.textContent=l; sel.appendChild(o);}
  sel.onchange=()=>{dirty=true;};});
fetch('controls').then(r=>r.json()).then(cs=>{
  const bar=document.getElementById('ctrls');
  for(const [name,c] of Object.entries(cs)){
    ctrls[name]=c.value;
    const lab=document.createElement('label');
    lab.textContent=` ${name} `;
    const s=document.createElement('input');
    s.type='range'; s.min=c.min; s.max=c.max; s.step=c.step; s.value=c.value;
    const v=document.createElement('span'); v.textContent=c.value;
    s.oninput=()=>{ctrls[name]=parseFloat(s.value);
                   v.textContent=s.value; dirty=true;};
    bar.appendChild(lab); bar.appendChild(s); bar.appendChild(v);}});
function tick(){
  if(dirty && !busy){
    busy=true; dirty=false; const t0=performance.now();
    let u=`render?theta=${th}&phi=${ph}&radius=${r}&layer=${sel.value||''}`;
    u+=`&overlay=${document.getElementById('ov').checked?1:0}`;
    for(const [k,v] of Object.entries(ctrls)) u+=`&c_${k}=${v}`;
    fetch(u).then(r=>r.blob()).then(b=>{
      img.src=URL.createObjectURL(b); busy=false;
      stat.textContent=`${(performance.now()-t0).toFixed(0)} ms`;
    }).catch(()=>{busy=false;});
  }
  requestAnimationFrame(tick);}
tick();
let drag=null;
img.onmousedown=e=>{drag=[e.clientX,e.clientY];e.preventDefault();};
window.onmouseup=()=>{drag=null;};
window.onmousemove=e=>{ if(!drag) return;
  th+=(e.clientX-drag[0])*0.01; ph+=(e.clientY-drag[1])*0.01;
  ph=Math.max(-1.45,Math.min(1.45,ph)); drag=[e.clientX,e.clientY];
  dirty=true;};
img.onwheel=e=>{r*=Math.exp(e.deltaY*0.001); r=Math.max(0.3,Math.min(30,r));
  dirty=true; e.preventDefault();};
</script></body></html>"""


def _to_uint8_layer(arr: np.ndarray) -> np.ndarray:
    """Any rendered buffer → displayable uint8 HxWx3."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:                       # depth / alpha → grayscale
        lo, hi = np.nanmin(arr), np.nanmax(arr)
        arr = (arr - lo) / (hi - lo + 1e-9)
        arr = np.repeat(arr, 3, axis=-1)
    elif arr.shape[-1] == 3 and arr.min() < -1e-3:   # normals → [0,1]
        arr = arr * 0.5 + 0.5
    arr = arr[..., :3]
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


class InteractiveViewer:
    """Serve an orbit-controlled live render of `model` over HTTP.

    model: anything with `ray_test`/`ray_query` (a `ModelMixin`); hw: the
    render's resolution; generator: the draws of a perturbed render
    (None: unperturbed).
    """

    def __init__(self, model, hw: Tuple[int, int] = (256, 256),
                 host: str = "0.0.0.0", port: int = 0,
                 center=(0.0, 0.0, 0.0),
                 generator: Optional[torch.Generator] = None,
                 controls: Optional[Dict[str, Dict]] = None,
                 overlays=None):
        """controls: per-frame scene conditions shown as sliders, e.g.
        {"ts": {"min": -1, "max": 1, "step": 0.05, "value": 0.0}} for a
        dynamic model or {"bidx": {"min": 0, "max": 3, "step": 1,
        "value": 0}} for a batched one; their values go to every ray of
        the frame (`NeuralRenderer.render`'s ray_extras). overlays:
        `gui_datalayers` line sets."""
        from nr3d_lib_tpu_torch.gui import NeuralRenderer

        self._renderer = NeuralRenderer(model, hw)
        self._overlays = list(overlays or [])
        self._center = np.asarray(center, np.float32)
        self._generator = generator
        self._lock = threading.Lock()
        self._host, self._port = host, port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._layers: Optional[Tuple[str, ...]] = None
        self._controls = {
            name: {"min": float(c.get("min", 0.0)),
                   "max": float(c.get("max", 1.0)),
                   "step": float(c.get("step", 0.01)),
                   "value": float(c.get("value", 0.0))}
            for name, c in (controls or {}).items()}

    # ----------------------------------------------------------- rendering
    def camera(self, theta: float, phi: float, radius: float) -> np.ndarray:
        """The orbit camera's c2w [4, 4] (computed on the CPU, so that it
        is the same whatever the model's device)."""
        from nr3d_lib_tpu_torch.graphics.cameras import look_at

        eye = self._center + radius * np.asarray(
            [np.cos(theta) * np.cos(phi), np.sin(phi),
             np.sin(theta) * np.cos(phi)], np.float32)
        return look_at(torch.from_numpy(eye),
                       torch.from_numpy(self._center)).numpy()

    def _render(self, theta: float, phi: float, radius: float,
                extras: Optional[Dict[str, float]] = None
                ) -> Dict[str, np.ndarray]:
        c2w = self.camera(theta, phi, radius)
        vals = {n: c["value"] for n, c in self._controls.items()}
        vals.update(extras or {})
        with self._lock:
            return self._renderer.render(c2w, generator=self._generator,
                                         ray_extras=vals or None)

    def layers(self) -> Tuple[str, ...]:
        if self._layers is None:
            images = self._render(0.6, 0.35, 3.0)
            names = [k for k, v in images.items()
                     if np.asarray(v).ndim in (2, 3)]
            # rgb first: it is the default the page lands on
            names.sort(key=lambda k: (not k.startswith("rgb"), k))
            self._layers = tuple(names)
        return self._layers

    def frame_png(self, theta: float, phi: float, radius: float,
                  layer: str = "",
                  extras: Optional[Dict[str, float]] = None,
                  overlay: bool = False) -> bytes:
        """One frame of `layer` (the first layer if unknown) as PNG bytes,
        with the overlays drawn when `overlay`."""
        images = self._render(theta, phi, radius, extras)
        names = self.layers()
        if layer not in images:
            layer = names[0]
        img = _to_uint8_layer(images[layer])
        if overlay and self._overlays:
            from nr3d_lib_tpu_torch.gui_datalayers import draw_datalayers

            img = draw_datalayers(img, self._overlays,
                                  to_numpy(self._renderer.intr),
                                  self.camera(theta, phi, radius))
        return encode_png(img)

    # ------------------------------------------------------------- server
    def start(self) -> str:
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):               # silence stdout
                pass

            def _reply(self, code: int, ctype: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                try:
                    if u.path in ("/", "/index.html"):
                        self._reply(200, "text/html", _PAGE.encode())
                    elif u.path == "/layers":
                        self._reply(200, "application/json",
                                    json.dumps(list(viewer.layers())).encode())
                    elif u.path == "/controls":
                        self._reply(200, "application/json",
                                    json.dumps(viewer._controls).encode())
                    elif u.path == "/render":
                        q = parse_qs(u.query)

                        def f(name, default):
                            return float(q.get(name, [default])[0])

                        extras = {k[2:]: float(v[0]) for k, v in q.items()
                                  if k.startswith("c_")
                                  and k[2:] in viewer._controls}
                        png = viewer.frame_png(
                            f("theta", 0.6), f("phi", 0.35),
                            f("radius", 3.0), q.get("layer", [""])[0],
                            extras,
                            overlay=q.get("overlay", ["0"])[0] == "1")
                        self._reply(200, "image/png", png)
                    else:
                        self._reply(404, "text/plain", b"not found")
                except BrokenPipeError:              # client gone mid-frame
                    pass
                except Exception as e:               # surface render errors
                    self._reply(500, "text/plain", repr(e).encode())

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return f"http://{self._host}:{self._httpd.server_address[1]}"

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
