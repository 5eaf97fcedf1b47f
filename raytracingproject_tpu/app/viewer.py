"""Interactive progressive viewer (capability ref: the standalone GL
viewport with keyboard camera navigation, app/cycles_standalone.cpp:
366-536 + app/cycles_xml viewport loop — redesigned headless-friendly:
an embedded HTTP server streams progressive PNG frames to a browser
and accepts camera-navigation commands, since the deployment target
has no GL stack).

    python -m raytracingproject_tpu.app.viewer scene.xml --port 8555

Browser keys (index page): W/S dolly, A/D truck, R/F pedestal,
arrow keys orbit, 0 reset. Every navigation restarts the progressive
refinement loop (Session.render_preview resolution dividers).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>raytracingproject_tpu viewer</title><style>
body{background:#181818;color:#ccc;font-family:monospace;text-align:center}
img{image-rendering:pixelated;border:1px solid #333;margin-top:12px}
</style></head><body>
<div id=s>connecting…</div><img id=v width=512>
<div>W/S dolly · A/D truck · R/F pedestal · arrows orbit · 0 reset</div>
<script>
const v=document.getElementById('v'),s=document.getElementById('s');
let seq=0;
async function poll(){
  try{
    const r=await fetch('/status');const j=await r.json();
    s.textContent=`${j.width}x${j.height} · level ${j.level} · `+
                  `${j.samples} spp · frame ${j.seq}`;
    if(j.seq!=seq){seq=j.seq;v.src='/frame.png?'+seq;}
  }catch(e){s.textContent='disconnected';}
  setTimeout(poll,250);}
poll();
const keys={'w':'dolly:1','s':'dolly:-1','a':'truck:-1','d':'truck:1',
            'r':'pedestal:1','f':'pedestal:-1','ArrowLeft':'orbit:-1,0',
            'ArrowRight':'orbit:1,0','ArrowUp':'orbit:0,1',
            'ArrowDown':'orbit:0,-1','0':'reset:0'};
document.addEventListener('keydown',e=>{const k=keys[e.key];
  if(k)fetch('/nav',{method:'POST',body:k});});
</script></body></html>"""


class ViewerState:
    """Render loop driver: restartable progressive refinement."""

    def __init__(self, scene, samples=64, dividers=(8, 4, 2, 1)):
        from raytracingproject_tpu.session import Session, SessionParams
        self.scene = scene
        self.session = Session(scene, SessionParams(samples=samples))
        self.dividers = dividers
        self.lock = threading.Lock()
        self.frame = np.zeros((8, 8, 4), np.float32)
        self.seq = 0
        self.level = 0
        self.samples = 0
        self._restart = threading.Event()
        self._stop = threading.Event()
        self._home = np.asarray(scene.camera.matrix, np.float32).copy()
        self.thread = threading.Thread(target=self._run, daemon=True)

    # --- camera navigation (ref: cycles_standalone.cpp keyboard()) ---
    def navigate(self, cmd):
        arg = cmd.split(":", 1)
        name, val = arg[0], (arg[1] if len(arg) > 1 else "0")
        cam = self.scene.camera
        m = np.asarray(cam.matrix, np.float32).copy()
        right, up, fwd = m[:3, 0], m[:3, 1], m[:3, 2]
        step = 0.5
        if name == "reset":
            m = self._home.copy()
        elif name == "dolly":
            m[:3, 3] += fwd * step * float(val)
        elif name == "truck":
            m[:3, 3] += right * step * float(val)
        elif name == "pedestal":
            m[:3, 3] += up * step * float(val)
        elif name == "orbit":
            dx, dy = (float(x) for x in val.split(","))
            ang = np.radians(10.0)
            for axis, amt in ((up, dx), (right, -dy)):
                if amt == 0:
                    continue
                c, s = np.cos(ang * amt), np.sin(ang * amt)
                k = axis / max(np.linalg.norm(axis), 1e-9)
                K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                              [-k[1], k[0], 0]], np.float32)
                R = np.eye(3, dtype=np.float32) + s * K + (1 - c) * (K @ K)
                m[:3, :3] = R @ m[:3, :3]
        else:
            raise ValueError(f"unknown nav command {name!r}")
        cam.set("matrix", m.astype(np.float32))
        self._restart.set()

    def _run(self):
        while not self._stop.is_set():
            self._restart.clear()
            try:
                for li, img in enumerate(self.session.render_preview(
                        dividers=self.dividers)):
                    with self.lock:
                        self.frame = np.asarray(img)
                        self.seq += 1
                        self.level = li
                        self.samples = self.session.buffers.num_samples
                    if self._restart.is_set() or self._stop.is_set():
                        break
            except Exception as e:          # pragma: no cover
                with self.lock:
                    self.error = str(e)
                time.sleep(0.5)
            # idle until a navigation arrives (frame is converged)
            while not self._restart.wait(timeout=0.1):
                if self._stop.is_set():
                    return

    def png_bytes(self):
        from raytracingproject_tpu.utils.image_io import encode_png
        with self.lock:
            rgba = self.frame
        img = np.clip(rgba[::-1, :, :3], 0.0, 1.0)
        srgb = np.where(img <= 0.0031308, img * 12.92,
                        1.055 * np.power(np.maximum(img, 1e-8), 1 / 2.4)
                        - 0.055)
        return encode_png((srgb * 255).astype(np.uint8))

    def status(self):
        cam = self.scene.camera
        with self.lock:
            return {"seq": self.seq, "level": self.level,
                    "samples": int(self.samples),
                    "width": int(cam.width), "height": int(cam.height)}

    def start(self):
        self.thread.start()

    def stop(self):
        self._stop.set()
        self._restart.set()


def make_server(state, port=8555, host="127.0.0.1"):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                self._send(200, "image/png", state.png_bytes())
            elif self.path.startswith("/status"):
                self._send(200, "application/json",
                           json.dumps(state.status()).encode())
            else:
                self._send(200, "text/html", _PAGE.encode())

        def do_POST(self):
            if self.path == "/nav":
                n = int(self.headers.get("Content-Length", 0))
                cmd = self.rfile.read(n).decode()
                try:
                    state.navigate(cmd)
                    self._send(200, "text/plain", b"ok")
                except ValueError as e:
                    self._send(400, "text/plain", str(e).encode())
            else:
                self._send(404, "text/plain", b"?")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("scene")
    parser.add_argument("--port", type=int, default=8555)
    parser.add_argument("--samples", type=int, default=64)
    args = parser.parse_args(argv)
    from raytracingproject_tpu.app.xml import read_scene
    scene = read_scene(args.scene)
    state = ViewerState(scene, samples=args.samples)
    state.start()
    srv = make_server(state, args.port)
    print(f"viewer at http://127.0.0.1:{args.port}/ — ctrl-c to stop")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.stop()


if __name__ == "__main__":
    main()
