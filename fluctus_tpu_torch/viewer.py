"""Browser live viewer (the reference package's viewer.py; the original
renderer's PTWindow/GL display, src/window.cpp, src/tracer_ui.cpp).

A threaded stdlib HTTP server shows the latest frame (refreshed every 2 s),
a toolbar of widgets initialised from ``/state.json``, and forwards every
command to the REPL's interpreter (``interactive.run_interactive``), which
runs on the calling thread. The handler threads only read the frame file
and ``_widget_state`` (plain Python values): no CUDA call happens on them.

Usage:  python -m fluctus_tpu_torch <scene> --serve 8000
then open http://localhost:8000 (port-forward when remote).
"""

from __future__ import annotations

import html
import json
import os
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

_PAGE = """<!DOCTYPE html>
<html><head><title>fluctus_tpu_torch</title><style>
body {{ background: #1b1b1f; color: #ddd; font-family: monospace;
       display: flex; flex-direction: column; align-items: center; }}
img {{ image-rendering: pixelated; max-width: 90vw; border: 1px solid #444;
       cursor: crosshair; }}
input[name=c] {{ background: #2a2a2f; color: #ddd; border: 1px solid #555;
         padding: 4px; width: 28em; }}
pre {{ color: #9a9; }}
#panels {{ display: flex; flex-wrap: wrap; gap: 8px; max-width: 92vw;
           justify-content: center; }}
fieldset {{ border: 1px solid #444; padding: 4px 8px; }}
legend {{ color: #8ac; }}
label {{ display: block; margin: 2px 0; }}
fieldset input, fieldset select {{ background: #2a2a2f; color: #ddd;
  border: 1px solid #555; vertical-align: middle; }}
input[type=range] {{ width: 9em; }}
input[type=number] {{ width: 4.5em; }}
button {{ background: #2a2a2f; color: #ddd; border: 1px solid #555;
          margin: 1px; }}
</style></head><body>
<h3>fluctus_tpu_torch — live render</h3>
<img id="frame" src="/frame.png" alt="(no frame yet)"
 title="click to set DoF focal distance (pick)">
<div id="panels">
<fieldset><legend>renderer</legend>
<label>integrator <select id="integrator" onchange="cmd('integrator '+this.value)">
<option value="wf">wavefront</option><option value="mk">microkernel</option>
</select></label>
<label>path depth <input id="depth" type="number" min="1" max="64"
 onchange="cmd('depth '+this.value)"></label>
<label><input id="rr" type="checkbox"
 onchange="cmd('rr '+(this.checked?1:0))"> russian roulette</label>
<label>max spp <input id="maxspp" type="number" min="0"
 onchange="cmd('maxspp '+this.value)"></label>
<label>render scale <input id="scale" type="range" min="0.1" max="2"
 step="0.05" onchange="cmd('scale '+this.value)"></label>
<button onclick="cmd('sampling')">cycle sampling</button>
<button onclick="cmd('light')">cycle lights</button>
</fieldset>
<fieldset><legend>camera</legend>
<label>fov <input id="fov" type="range" min="1" max="120" step="1"
 onchange="cmd('fov '+this.value)"></label>
<label>speed <input id="speed" type="range" min="0.1" max="100" step="0.1"
 onchange="cmd('speed '+this.value)"></label>
<label>aperture <input id="aperture" type="range" min="0" max="0.003"
 step="0.0001" onchange="cmd('aperture '+this.value)"></label>
<div>
<button onclick="cmd('w')">&#8593;fwd</button>
<button onclick="cmd('s')">&#8595;back</button>
<button onclick="cmd('a')">&#8592;</button>
<button onclick="cmd('d')">&#8594;</button>
<button onclick="cmd('r')">up</button>
<button onclick="cmd('f')">down</button></div>
<div>
<button onclick="cmd('look -10 0')">&#8634; look</button>
<button onclick="cmd('look 10 0')">look &#8635;</button>
<button onclick="cmd('look 0 10')">look &#8593;</button>
<button onclick="cmd('look 0 -10')">look &#8595;</button></div>
</fieldset>
<fieldset><legend>tonemap</legend>
<label>operator <select id="tonemap" onchange="cmd('tonemap '+this.value)">
<option value="0">linear</option><option value="1">Reinhard</option>
<option value="2">UC2 filmic</option><option value="3">raw</option>
</select></label>
<label>exposure <input id="exposure" type="range" min="0.1" max="5"
 step="0.1" onchange="cmd('exposure '+this.value)"></label>
</fieldset>
<fieldset><legend>denoiser</legend>
<label><input id="denoise" type="checkbox"
 onchange="cmd('denoise '+(this.checked?1:0))"> enable</label>
<label>blend <input id="blend" type="range" min="0" max="1" step="0.05"
 onchange="cmd('blend '+this.value)"></label>
</fieldset>
<fieldset><legend>env map</legend>
<label>strength <input id="envstrength" type="range" min="0.1" max="10"
 step="0.1" onchange="cmd('envstrength '+this.value)"></label>
</fieldset>
<fieldset><legend>area light</legend>
<label>size <input id="al_size" type="range" min="0.1" max="30" step="0.1"
 onchange="cmd('arealight size '+this.value)"></label>
<label>intensity <input id="al_int" type="range" min="0.1" max="100"
 step="0.1" onchange="cmd('arealight int '+this.value)"></label>
<label>color <input id="al_color" type="color"
 onchange="cmd('arealight color '+hex2rgb(this.value))"></label>
</fieldset>
<fieldset><legend>state</legend>
<button onclick="cmd('save')">save (F2)</button>
<button onclick="cmd('load')">load (F1)</button>
<button onclick="cmd('more')">refine</button>
<button onclick="cmd('preview')">fast preview</button>
</fieldset>
</div>
<p><form method="post" action="/cmd">
<input name="c" placeholder="any REPL command: mat 0 kd 1 0 0, scene 2, pick .5 .5, png out.png, q ..."
 autofocus></form></p>
<pre>{log}</pre>
<script>
function cmd(c) {{
  fetch('/cmd', {{method: 'POST',
    headers: {{'Content-Type': 'application/x-www-form-urlencoded'}},
    body: 'c=' + encodeURIComponent(c)}});
}}
function hex2rgb(h) {{
  return [1, 3, 5].map(i => (parseInt(h.slice(i, i + 2), 16) / 255)
                             .toFixed(3)).join(' ');
}}
// click-to-pick: NDC coords, film row 0 at the bottom (right-click
// focal pick analogue, tracer.cpp:1427-1433)
document.getElementById("frame").addEventListener("click", e => {{
  const r = e.target.getBoundingClientRect();
  const x = (e.clientX - r.left) / r.width;
  const y = 1 - (e.clientY - r.top) / r.height;
  cmd('pick ' + x.toFixed(4) + ' ' + y.toFixed(4));
}});
// initialize widgets from the live render state (updateGUI analogue,
// tracer_ui.cpp:525+)
fetch('/state.json').then(r => r.json()).then(st => {{
  for (const [k, v] of Object.entries(st)) {{
    const el = document.getElementById(k);
    if (!el) continue;
    if (el.type === 'checkbox') el.checked = !!v;
    else el.value = v;
  }}
}});
setInterval(() => {{
  document.getElementById("frame").src = "/frame.png?ts=" + Date.now();
}}, 2000);
</script></body></html>"""


def _widget_state(renderer) -> dict:
    """Current values for every toolbar widget, keyed by element id (the
    updateGUI analogue, tracer_ui.cpp:525+)."""
    s = renderer.settings
    a = s.area_light
    peak = max(max(a.E), 1e-9)
    rgb = tuple(int(round(e / peak * 255)) for e in a.E)
    return {
        "integrator": getattr(renderer, "preview_integrator", "wf"),
        "depth": s.max_path_depth,
        "rr": s.use_russian_roulette,
        "maxspp": s.max_spp,
        "scale": s.render_scale,
        "fov": s.camera.fov,
        "speed": s.camera.camera_speed,
        "aperture": s.camera.aperture_size,
        "tonemap": s.tonemap,
        "exposure": renderer.exposure,
        "denoise": s.use_denoiser,
        "blend": s.denoiser_blend,
        "envstrength": renderer.env_map_strength,
        "al_size": a.size[0],
        "al_int": peak,
        "al_color": "#%02x%02x%02x" % rgb,
    }


class _QueueStream:
    """Blocking line source for run_interactive, fed by HTTP posts."""

    def __init__(self):
        self.q = queue.Queue()

    def put(self, line: str):
        self.q.put(line)

    def __iter__(self):
        return self

    def __next__(self):
        line = self.q.get()
        if line is None:
            raise StopIteration
        return line


def serve(renderer, port: int = 8000, out_path: str = "preview.png",
          ready_event: threading.Event = None, host: str = "127.0.0.1"):
    """Run the viewer: the HTTP server on ``host:port`` and the REPL on
    the calling thread. Returns run_interactive's count when
    the user sends ``q``. Binds loopback by default: the command channel
    is unauthenticated (``png <path>`` writes files, ``scene`` loads any
    path), so reach it remotely through an SSH port-forward."""
    from .interactive import run_interactive

    stream = _QueueStream()
    log_lines = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):       # quiet
            pass

        def _send(self, ctype, body, cache=False):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            if not cache:
                self.send_header("Cache-Control", "no-store")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/state.json"):
                self._send("application/json",
                           json.dumps(_widget_state(renderer)).encode())
                return
            if self.path.startswith("/frame.png"):
                try:
                    with open(out_path, "rb") as f:
                        data = f.read()
                except FileNotFoundError:
                    self.send_response(404)
                    self.end_headers()
                    return
                self._send("image/png", data)
                return
            body = _PAGE.format(log=html.escape(
                "\n".join(log_lines[-12:]))).encode()
            self._send("text/html; charset=utf-8", body, cache=True)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            q = parse_qs(self.rfile.read(n).decode())
            cmd = (q.get("c") or [""])[0].strip()
            if cmd:
                log_lines.append("> " + cmd)
                stream.put(cmd + "\n")
            self.send_response(303)
            self.send_header("Location", "/")
            self.end_headers()

    server = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    if ready_event is not None:
        ready_event.set()
    print(f"viewer: http://localhost:{server.server_address[1]}/ "
          f"(send 'q' to quit)", flush=True)
    try:
        return run_interactive(renderer, out_path=out_path,
                               input_stream=stream)
    finally:
        server.shutdown()
        server.server_close()
        t.join()
