"""Live interactive viewer: a browser canvas over the running simulator.

Port of `fem_simulation_tpu/render/live.py`. `LiveViewer` runs two daemon
threads:

- a sim thread calling `sim.frame()` continuously (the solve runs on the
  simulator's device) and copying the positions to the host once a frame
  (one `.cpu()` copy);
- a localhost HTTP server serving a self-contained vanilla-JS page (no GL,
  no external assets: flat-shaded painter-sorted triangles on a 2D canvas)
  plus a small JSON API.

Interaction:
- orbit / zoom        -> client-side camera (render/camera.py math in JS)
- LMB drag on mesh    -> POST /pick {select|move|clear}; the server rebuilds
  a `Camera` from the client's state and runs the same unproject + Picker
  path as the scripted HeadlessWindow, feeding drag constraints into the
  dynamic solve (sim/picking.py).
- Space pause         -> POST /pause toggle, honored by the sim thread.

One lock guards the simulator: the sim thread's frame and readback, and
the picker's readback and `set_drag`. The browser is a dumb terminal, so a
test can drive the whole API with urllib and no browser.
"""
from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .camera import Camera
from ..sim.picking import Picker


def _camera_from_state(cam: dict, width: int, height: int) -> Camera:
    return Camera(position=cam["position"], target=cam["target"],
                  up=cam.get("up", (0.0, 1.0, 0.0)),
                  fov_deg=cam.get("fov_deg", 45.0),
                  aspect=width / max(height, 1))


class LiveViewer:
    """Serve a live view of `sim` (DynamicSim / ClothSim duck-type: needs
    `.frame()`, `.state.x`, `.scene`) with mouse picking.

    tris_mesh_order: (T, 3) surface triangles in MESH vertex order
    (mesh.surface_triangles). start() returns the URL; stop() joins both
    threads. `fps_cap` bounds the sim thread so a fast solve does not
    busy-spin the host between browser polls.
    """

    def __init__(self, sim, tris_mesh_order: np.ndarray,
                 host: str = "127.0.0.1", port: int = 0,
                 fps_cap: float = 60.0, grab_radius2: float = 0.002):
        self.sim = sim
        self.tris = np.asarray(tris_mesh_order, dtype=np.int32)
        self.picker = Picker(sim, self.tris, grab_radius2=grab_radius2)
        self._host, self._port = host, port
        self._fps_cap = fps_cap
        self.paused = False
        self.frame_no = 0
        self.sim_fps = 0.0
        self._lock = threading.Lock()        # guards sim state + picker
        self._x_mesh = self._read_x()
        self._stop = threading.Event()
        self._httpd = None
        self._threads = []

    # -- sim side -----------------------------------------------------------
    def _read_x(self) -> np.ndarray:
        x = self.sim.state.x.detach().cpu().numpy()   # waits for the frame
        scene = self.sim.scene
        if hasattr(scene, "to_mesh_order"):
            x = scene.to_mesh_order(x)
        return np.asarray(x, dtype=np.float32)

    def _sim_loop(self):
        min_dt = 1.0 / self._fps_cap
        t_prev = time.monotonic()
        while not self._stop.is_set():
            if self.paused:
                time.sleep(0.02)
                continue
            with self._lock:
                self.sim.frame()
                self._x_mesh = self._read_x()
                self.frame_no += 1
            now = time.monotonic()
            dt = now - t_prev
            self.sim_fps = 1.0 / max(dt, 1e-9)
            t_prev = now
            if dt < min_dt:
                time.sleep(min_dt - dt)

    # -- API handlers (called from HTTP threads) ----------------------------
    def _state_payload(self) -> bytes:
        with self._lock:
            x = self._x_mesh
            n = self.frame_no
        return json.dumps({
            "frame": n, "paused": self.paused,
            "sim_fps": round(self.sim_fps, 1),
            "x_b64": base64.b64encode(
                np.ascontiguousarray(x, np.float32).tobytes()).decode(),
        }).encode()

    def _mesh_payload(self) -> bytes:
        x = self._x_mesh
        return json.dumps({
            "n_verts": int(x.shape[0]),
            "tris": self.tris.reshape(-1).tolist(),
            "center": x.mean(axis=0).tolist(),
            "radius": float(np.linalg.norm(
                x - x.mean(axis=0), axis=1).max()),
        }).encode()

    def _handle_pick(self, msg: dict) -> bytes:
        with self._lock:
            if msg["mode"] == "clear":
                self.picker.clear()
                hit = False
            else:
                cam = _camera_from_state(msg["cam"], msg["w"], msg["h"])
                o, d = cam.unproject(msg["sx"], msg["sy"], msg["w"], msg["h"])
                # picker reads canonical-order x; its tris were remapped
                if msg["mode"] == "select":
                    hit = self.picker.select(o, d)
                else:                       # "move"
                    self.picker.move_select(o, d)
                    hit = self.picker.select_vertex >= 0
        return json.dumps({"hit": bool(hit),
                           "vertex": int(self.picker.select_vertex)}).encode()

    def _handle_pause(self) -> bytes:
        self.paused = not self.paused       # Space
        return json.dumps({"paused": self.paused}).encode()

    # -- server -------------------------------------------------------------
    def start(self) -> str:
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def _send(self, body: bytes, ctype="application/json"):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(_PAGE.encode(), "text/html; charset=utf-8")
                elif self.path.startswith("/state"):
                    self._send(viewer._state_payload())
                elif self.path.startswith("/mesh"):
                    self._send(viewer._mesh_payload())
                else:
                    self.send_error(404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b"{}"
                if self.path.startswith("/pick"):
                    self._send(viewer._handle_pick(json.loads(raw)))
                elif self.path.startswith("/pause"):
                    self._send(viewer._handle_pause())
                else:
                    self.send_error(404)

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever, daemon=True),
            threading.Thread(target=self._sim_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def stop(self):
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=5.0)


# Self-contained page: software renderer (view/proj matrices exactly as
# render/camera.py) + orbit/zoom + LMB pick-drag + Space pause.
_PAGE = r"""<!doctype html>
<meta charset="utf-8"><title>fem_simulation_tpu_torch live</title>
<style>
 body{margin:0;background:#10131a;color:#cdd3df;font:13px monospace;overflow:hidden}
 #hud{position:fixed;left:10px;top:8px;white-space:pre;pointer-events:none}
 canvas{display:block;cursor:grab}
</style>
<div id="hud"></div><canvas id="c"></canvas>
<script>
"use strict";
const cv=document.getElementById("c"),ctx=cv.getContext("2d"),hud=document.getElementById("hud");
let W,H;function fit(){W=cv.width=innerWidth;H=cv.height=innerHeight;}fit();onresize=fit;
const cam={position:[0,0.5,3],target:[0,0,0],up:[0,1,0],fov_deg:45};
let tris=null,X=null,frame=0,paused=false,simFps=0,dragging=null,picked=false;
const sub=(a,b)=>[a[0]-b[0],a[1]-b[1],a[2]-b[2]];
const cross=(a,b)=>[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];
const dot=(a,b)=>a[0]*b[0]+a[1]*b[1]+a[2]*b[2];
const norm=a=>{const n=Math.hypot(a[0],a[1],a[2])+1e-12;return[a[0]/n,a[1]/n,a[2]/n]};
function viewProj(){ // render/camera.py view()/proj()
  const f=norm(sub(cam.target,cam.position)),s=norm(cross(f,cam.up)),u=cross(s,f);
  const p=cam.position,t=Math.tan(Math.PI*cam.fov_deg/360),a=W/H;
  const near=0.01,far=100;
  return{s:s,u:u,f:f,tx:-dot(s,p),ty:-dot(u,p),tz:dot(f,p),
         px:1/(t*a),py:1/t,pz:(far+near)/(near-far),pw:2*far*near/(near-far)};
}
function orbit(dyaw,dpitch){ // camera.rotate()
  const off=sub(cam.position,cam.target),r=Math.hypot(off[0],off[1],off[2]);
  let yaw=Math.atan2(off[0],off[2])+dyaw;
  let pit=Math.asin(off[1]/(r+1e-12))+dpitch;pit=Math.max(-1.55,Math.min(1.55,pit));
  cam.position=[cam.target[0]+r*Math.cos(pit)*Math.sin(yaw),
                cam.target[1]+r*Math.sin(pit),
                cam.target[2]+r*Math.cos(pit)*Math.cos(yaw)];
}
async function post(url,body){const r=await fetch(url,{method:"POST",body:JSON.stringify(body)});return r.json();}
function pickMsg(mode,e){return{mode:mode,sx:e.clientX,sy:e.clientY,w:W,h:H,
  cam:{position:cam.position,target:cam.target,up:cam.up,fov_deg:cam.fov_deg}};}
cv.onmousedown=async e=>{
  if(e.button!==0)return;
  dragging={x:e.clientX,y:e.clientY,orbit:true};
  const r=await post("/pick",pickMsg("select",e));
  if(r.hit){picked=true;dragging.orbit=false;}
};
cv.onmousemove=e=>{
  if(!dragging)return;
  if(dragging.orbit){orbit(-(e.clientX-dragging.x)*0.01,(e.clientY-dragging.y)*0.01);
    dragging.x=e.clientX;dragging.y=e.clientY;}
  else post("/pick",pickMsg("move",e));
};
cv.onmouseup=async()=>{if(picked)await post("/pick",{mode:"clear"});picked=false;dragging=null;};
onwheel=e=>{const f=norm(sub(cam.target,cam.position)),d=e.deltaY<0?0.1:-0.1;
  cam.position=[cam.position[0]+d*f[0],cam.position[1]+d*f[1],cam.position[2]+d*f[2]];};
onkeydown=async e=>{if(e.code==="Space"){const r=await post("/pause",{});paused=r.paused;}};
function draw(){
  ctx.fillStyle="#10131a";ctx.fillRect(0,0,W,H);
  if(X&&tris){
    const m=viewProj(),n=X.length/3,px=new Float32Array(n),py=new Float32Array(n),pz=new Float32Array(n);
    for(let i=0;i<n;i++){
      const x=X[3*i],y=X[3*i+1],z=X[3*i+2];
      const vx=m.s[0]*x+m.s[1]*y+m.s[2]*z+m.tx;
      const vy=m.u[0]*x+m.u[1]*y+m.u[2]*z+m.ty;
      const vz=-(m.f[0]*x+m.f[1]*y+m.f[2]*z)+m.tz;
      const w=-vz; // perspective divide by view depth
      px[i]=(m.px*vx/w*0.5+0.5)*W;py[i]=(0.5-m.py*vy/w*0.5)*H;pz[i]=w;
    }
    const T=tris.length/3,order=new Array(T),depth=new Float32Array(T);
    const light=norm([0.4,0.8,0.45]);
    for(let t=0;t<T;t++){order[t]=t;
      depth[t]=(pz[tris[3*t]]+pz[tris[3*t+1]]+pz[tris[3*t+2]])/3;}
    order.sort((a,b)=>depth[b]-depth[a]); // painter: far first
    for(const t of order){
      const a=tris[3*t],b=tris[3*t+1],c=tris[3*t+2];
      if(depth[t]<=0.01)continue;
      const e1=[X[3*b]-X[3*a],X[3*b+1]-X[3*a+1],X[3*b+2]-X[3*a+2]];
      const e2=[X[3*c]-X[3*a],X[3*c+1]-X[3*a+1],X[3*c+2]-X[3*a+2]];
      const nrm=norm(cross(e1,e2));
      const sh=Math.max(0.15,Math.abs(dot(nrm,light))); // utils/viz._tri_shade
      ctx.fillStyle=`rgb(${34+170*sh|0},${48+160*sh|0},${78+140*sh|0})`;
      ctx.beginPath();ctx.moveTo(px[a],py[a]);ctx.lineTo(px[b],py[b]);
      ctx.lineTo(px[c],py[c]);ctx.closePath();ctx.fill();
    }
  }
  hud.textContent=`frame ${frame}  sim ${simFps} fps${paused?"  [paused]":""}\n`+
    `drag: LMB on mesh   orbit: LMB on space   zoom: wheel   pause: Space`;
  requestAnimationFrame(draw);
}
async function init(){
  const mi=await (await fetch("/mesh")).json();
  tris=new Int32Array(mi.tris);
  cam.target=mi.center;
  const r=mi.radius*2.8/Math.tan(Math.PI*cam.fov_deg/360)*0.5;
  cam.position=[mi.center[0],mi.center[1]+0.3*r,mi.center[2]+r];
  (async function poll(){
    while(true){
      try{
        const s=await (await fetch("/state")).json();
        frame=s.frame;paused=s.paused;simFps=s.sim_fps;
        const raw=atob(s.x_b64),buf=new Uint8Array(raw.length);
        for(let i=0;i<raw.length;i++)buf[i]=raw.charCodeAt(i);
        X=new Float32Array(buf.buffer);
      }catch(e){await new Promise(r=>setTimeout(r,250));}
      await new Promise(r=>setTimeout(r,33));
    }
  })();
  draw();
}
init();
</script>
"""
