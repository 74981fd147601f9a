"""Web viewer: live free-fly rendering and the training-option panel over
HTTP.

Counterpart of photo_slam_tpu/viewer/server.py, which replaces the
reference's ImGui/GLFW/OpenGL viewer (reference: viewer/imgui_viewer.{h,cpp})
with a dependency-free stdlib HTTP server; the browser is the GUI. Routes:

  GET  /            the viewer page (canvas, WASD/mouse fly controls, the
                    live training options of the reference's Training
                    Options panel, imgui_viewer.cpp:420-467)
  GET  /render      ?qw&qx&qy&qz&tx&ty&tz&w&h -> PNG render of that pose
                    (the renderFromPose service, gaussian_mapper.cpp:1521-1569)
  GET  /status      JSON training status (iteration, loss, #gaussians)
  GET  /map         JSON map geometry: keyframe frusta, sparse map points,
                    covisibility edges (the reference's map drawer,
                    viewer/map_drawer.cpp), drawn over the splat render
  GET  /frame       PNG of the tracker's current frame with its keypoints
                    (the reference's SLAM-frame view, imgui_viewer.cpp:341-360)
  GET  /params      JSON VariableParameters
  POST /params      set VariableParameters
  POST /stop        signal the mapper to stop

Renders go through mapper.render_from_pose, which holds the mapper's render
lock only while it reads the map and enqueues the render (the reference's
mutex_render_, gaussian_mapper.cpp:1549); the copy to the host and the PNG
encode (io/images.encode_png: the card's machine has neither cv2 nor PIL)
run in the request's thread outside it. The server's profiler times each
/render request's stages: viewer.lock_wait, viewer.render, viewer.d2h and
viewer.png.
"""
from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from photo_slam_tpu_torch.io.images import encode_png
from photo_slam_tpu_torch.utils.math import se3_inverse, se3_matrix
from photo_slam_tpu_torch.utils.profiling import Profiler

# zlib level of the served PNGs: it sets the encode time and the size of a
# response, never its pixels. Stored blocks (0): a 1200x680 frame encodes
# in ~10 ms against ~67 ms at level 1 (chip_smoke.py's viewer phase, on the
# H100's host), for 2.4 MB against 1.5 MB on a local connection.
PNG_LEVEL = 0

_PAGE = """<!DOCTYPE html>
<html><head><title>photo_slam_tpu_torch viewer</title>
<style>
 body{margin:0;background:#111;color:#ddd;font-family:monospace;display:flex}
 #view{flex:1} #panel{width:300px;padding:12px;background:#1a1a1a}
 canvas{width:100%%;image-rendering:pixelated}
 input{width:80px;background:#222;color:#ddd;border:1px solid #444}
 .row{margin:4px 0} button{background:#333;color:#ddd;border:1px solid #555;
 padding:4px 10px;margin:2px}
</style></head><body>
<div id="view"><canvas id="c" width="%(w)d" height="%(h)d"></canvas></div>
<div id="panel">
 <h3>photo_slam_tpu_torch</h3>
 <div id="status">-</div><hr>
 <div>WASD move &middot; drag to look &middot; QE up/down</div><hr>
 <label><input type="checkbox" id="showmap" checked> map overlay
 (points / keyframes / covisibility)</label><hr>
 <img id="slamframe" style="width:100%%;display:none"><hr>
 <div id="params"></div>
 <button onclick="applyParams()">apply</button>
 <button onclick="fetch('/stop',{method:'POST'})">stop training</button>
</div>
<script>
let q=[1,0,0,0], t=[0,0,0], yaw=0, pitch=0, keys={}, drag=null;
const c=document.getElementById('c'), ctx=c.getContext('2d');
function pose(){
 const cy=Math.cos(yaw/2), sy=Math.sin(yaw/2);
 const cp=Math.cos(pitch/2), sp=Math.sin(pitch/2);
 return [cy*cp, cy*sp, sy*cp, -sy*sp];
}
let mapData=null;
setInterval(async()=>{try{
 mapData=await(await fetch('/map')).json();}catch(e){}},2000);
function rotOf(q){ // wxyz -> 3x3 row-major
 const[w,x,y,z]=q;
 return[1-2*(y*y+z*z),2*(x*y-w*z),2*(x*z+w*y),
        2*(x*y+w*z),1-2*(x*x+z*z),2*(y*z-w*x),
        2*(x*z-w*y),2*(y*z+w*x),1-2*(x*x+y*y)];
}
function proj(R,tv,fx,X){ // world point -> [u,v,z]
 const x=R[0]*X[0]+R[1]*X[1]+R[2]*X[2]+tv[0];
 const y=R[3]*X[0]+R[4]*X[1]+R[5]*X[2]+tv[1];
 const z=R[6]*X[0]+R[7]*X[1]+R[8]*X[2]+tv[2];
 return [c.width/2+fx*x/z, c.height/2+fx*y/z, z];
}
function drawOverlay(qq){
 if(!mapData||!document.getElementById('showmap').checked)return;
 const R=rotOf(qq), fx=(c.width/2)/Math.tan(mapData.fovx/2||0.5);
 ctx.save();
 // Sparse map points (reference: MapDrawer::DrawMapPoints).
 const pts=mapData.points||[], cols=mapData.colors;
 for(let i=0;i<pts.length;i++){
  const p=proj(R,t,fx,pts[i]); if(p[2]<=0.05)continue;
  ctx.fillStyle=cols?`rgb(${cols[i].map(v=>v*255|0)})`:'#3f3';
  ctx.fillRect(p[0]-1,p[1]-1,2,2);
 }
 // Keyframe frusta + covisibility (DrawKeyFrames + covisibility graph).
 const centers={};
 for(const kf of (mapData.keyframes||[])){
  const T=kf.twc, o=[T[0][3],T[1][3],T[2][3]]; centers[kf.id]=o;
  const s=0.12, a=mapData.aspect||0.75;
  const corners=[[s,s*a,2*s],[-s,s*a,2*s],[-s,-s*a,2*s],[s,-s*a,2*s]]
   .map(v=>[T[0][0]*v[0]+T[0][1]*v[1]+T[0][2]*v[2]+o[0],
            T[1][0]*v[0]+T[1][1]*v[1]+T[1][2]*v[2]+o[1],
            T[2][0]*v[0]+T[2][1]*v[1]+T[2][2]*v[2]+o[2]]);
  const po=proj(R,t,fx,o); if(po[2]<=0.05)continue;
  ctx.strokeStyle='#08f'; ctx.beginPath();
  for(let i=0;i<4;i++){
   const pc=proj(R,t,fx,corners[i]), pn=proj(R,t,fx,corners[(i+1)%%4]);
   if(pc[2]>0.05){ctx.moveTo(po[0],po[1]);ctx.lineTo(pc[0],pc[1]);
    if(pn[2]>0.05){ctx.moveTo(pc[0],pc[1]);ctx.lineTo(pn[0],pn[1]);}}
  }
  ctx.stroke();
 }
 ctx.strokeStyle='#fa0'; ctx.beginPath();
 for(const[a,b]of (mapData.edges||[])){
  if(centers[a]&&centers[b]){
   const pa=proj(R,t,fx,centers[a]), pb=proj(R,t,fx,centers[b]);
   if(pa[2]>0.05&&pb[2]>0.05){ctx.moveTo(pa[0],pa[1]);
    ctx.lineTo(pb[0],pb[1]);}}
 }
 ctx.stroke(); ctx.restore();
}
async function frame(){
 const qq=pose();
 const u=`/render?qw=${qq[0]}&qx=${qq[1]}&qy=${qq[2]}&qz=${qq[3]}`+
         `&tx=${t[0]}&ty=${t[1]}&tz=${t[2]}&w=${c.width}&h=${c.height}`;
 const img=new Image();
 img.onload=()=>{ctx.drawImage(img,0,0); drawOverlay(qq);
  requestAnimationFrame(frame);};
 img.onerror=()=>setTimeout(frame,500);
 img.src=u+`&_=${Date.now()}`;
}
onkeydown=e=>keys[e.key]=1; onkeyup=e=>keys[e.key]=0;
c.onmousedown=e=>drag=[e.clientX,e.clientY];
onmouseup=()=>drag=null;
onmousemove=e=>{if(drag){yaw+=(e.clientX-drag[0])*0.005;
 pitch+=(e.clientY-drag[1])*0.005; drag=[e.clientX,e.clientY];}};
setInterval(()=>{const v=0.05;
 if(keys['w'])t[2]+=v; if(keys['s'])t[2]-=v;
 if(keys['a'])t[0]-=v; if(keys['d'])t[0]+=v;
 if(keys['q'])t[1]-=v; if(keys['e'])t[1]+=v;},33);
setInterval(async()=>{
 const s=await(await fetch('/status')).json();
 document.getElementById('status').innerText=
  `iter ${s.iteration}  loss ${s.ema_loss.toFixed(4)}\\n`+
  `gaussians ${s.num_gaussians}  psnr ${s.last_psnr.toFixed(1)}`;
},1000);
async function loadParams(){
 const p=await(await fetch('/params')).json();
 document.getElementById('params').innerHTML=Object.entries(p).map(
  ([k,v])=>`<div class=row>${k}<br><input id="p_${k}" value="${v}"></div>`
 ).join('');
}
async function applyParams(){
 const out={};
 document.querySelectorAll('[id^=p_]').forEach(i=>{
  out[i.id.slice(2)]=parseFloat(i.value)||i.value;});
 await fetch('/params',{method:'POST',body:JSON.stringify(out)});
}
setInterval(()=>{const im=document.getElementById('slamframe');
 const probe=new Image();
 probe.onload=()=>{im.src=probe.src; im.style.display='block';};
 probe.src=`/frame?_=${Date.now()}`;},500);
loadParams(); frame();
</script></body></html>"""


class ViewerServer:
    """Serves the viewer for a running GaussianMapper."""

    def __init__(self, mapper, host: str = "127.0.0.1", port: int = 8090,
                 width: int = 640, height: int = 360):
        self.mapper = mapper
        self.width = width
        self.height = height
        self.profiler = Profiler()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                qs = urllib.parse.parse_qs(parsed.query)

                if parsed.path == "/":
                    page = (_PAGE % {"w": outer.width, "h": outer.height})
                    self._send(200, page.encode(), "text/html")
                elif parsed.path == "/status":
                    tr = outer.mapper.trainer
                    self._send(200, json.dumps({
                        "iteration": tr.iteration,
                        "ema_loss": tr.ema_loss,
                        "last_psnr": tr.metrics.last_psnr,
                        "num_gaussians": tr.metrics.num_live,
                    }).encode())
                elif parsed.path == "/map":
                    self._send(200, json.dumps(
                        outer.map_geometry()).encode())
                elif parsed.path == "/params":
                    self._send(200, json.dumps(
                        outer.mapper.get_variable_parameters()).encode())
                elif parsed.path == "/frame":
                    vis = getattr(outer.frontend, "last_frame_vis", None)
                    if vis is None:
                        self._send(404, b"no frame", "text/plain")
                    else:
                        self._send(200, _frame_png(*vis), "image/png")
                elif parsed.path == "/render":
                    try:
                        g = lambda k, d=0.0: float(qs.get(k, [d])[0])
                        quat = np.array([g("qw", 1.0), g("qx"), g("qy"),
                                         g("qz")])
                        trans = np.array([g("tx"), g("ty"), g("tz")])
                        w = int(g("w", outer.width))
                        h = int(g("h", outer.height))
                        img = outer.mapper.render_from_pose(
                            quat, trans, w, h, profiler=outer.profiler)
                        with outer.profiler.span("viewer.png"):
                            png = _to_png(img)
                        self._send(200, png, "image/png")
                    except Exception as e:  # noqa: BLE001
                        self._send(500, str(e).encode(), "text/plain")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b"{}"
                if self.path == "/params":
                    outer.mapper.set_variable_parameters(json.loads(body))
                    self._send(200, b"{}")
                elif self.path == "/stop":
                    outer.mapper.signal_stop()
                    self._send(200, b"{}")
                else:
                    self._send(404, b"not found", "text/plain")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    # Optional: a tracking frontend (tracking.frontend.SlamFrontend) for
    # covisibility edges; set by the app when one exists.
    frontend = None

    def map_geometry(self, max_points: int = 4000) -> dict:
        """Keyframe frusta + sparse points + covisibility edges — the data
        behind the reference's map drawer (reference: viewer/map_drawer.cpp:
        DrawMapPoints / DrawKeyFrames / covisibility graph)."""
        kfs = []
        scene = self.mapper.scene
        # list() snapshots: the mapper thread inserts keyframes concurrently.
        for fid, kf in sorted(list(scene.keyframes.items())):
            twc = se3_inverse(se3_matrix(kf.quat, kf.trans))
            kfs.append({"id": fid, "twc": np.round(twc[:3], 5).tolist()})

        pts = np.zeros((0, 3), np.float32)
        cols = None
        fe = self.frontend
        if fe is not None and getattr(fe, "map", None) is not None:
            # The tracker thread mutates the map while we read it: read _n
            # once and slice all arrays to that snapshot length so the mask
            # and data lengths cannot disagree mid-growth.
            n = int(fe.map._n)
            alive = np.array(fe.map.alive[:n], copy=True)
            pts = fe.map.xyz[:n][alive].astype(np.float32)
            cols = fe.map.color[:n][alive]
        elif getattr(self.mapper, "_sparse_log_pts", None):
            pts = np.concatenate(self.mapper._sparse_log_pts)
            if getattr(self.mapper, "_sparse_log_cols", None):
                cols = np.concatenate(self.mapper._sparse_log_cols)
        if len(pts) > max_points:
            sel = np.random.RandomState(0).choice(len(pts), max_points,
                                                  replace=False)
            pts = pts[sel]
            cols = cols[sel] if cols is not None else None

        edges = []
        if fe is not None and getattr(fe, "map", None) is not None:
            for kfid in list(fe.map.keyframes):
                try:
                    covis = fe.map.covisible_kfs(kfid)[:4]
                except (KeyError, IndexError):
                    continue  # keyframe mutated away under us
                for other in covis:
                    if other > kfid:
                        edges.append([kfid, other])
        else:
            ids = sorted(scene.keyframes)
            edges = [[a, b] for a, b in zip(ids[:-1], ids[1:])]

        cam = next(iter(scene.cameras.values()), None)
        return {
            "keyframes": kfs,
            "points": np.round(pts, 4).tolist(),
            "colors": (None if cols is None
                       else np.round(cols, 3).tolist()),
            "edges": edges,
            "fovx": (cam.fovx if cam is not None else 1.0),
            "aspect": (cam.height / cam.width if cam is not None else 0.75),
        }

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        if self._thread:
            self._thread.join(timeout=5)


def _frame_png(img_chw: np.ndarray, px) -> bytes:
    """Current tracked frame with keypoint markers (the reference's SLAM
    frame view draws ORB keypoints the same way,
    viewer/imgui_viewer.cpp:341-360)."""
    arr = (np.clip(np.transpose(img_chw, (1, 2, 0)), 0, 1) * 255).astype(
        np.uint8).copy()
    h, w = arr.shape[:2]
    if px is not None and len(px):
        u = np.clip(np.asarray(px)[:, 0].astype(int), 1, w - 2)
        v = np.clip(np.asarray(px)[:, 1].astype(int), 1, h - 2)
        for du in (-1, 0, 1):
            for dv in (-1, 0, 1):
                arr[v + dv, u + du] = (0, 255, 0)
    return encode_png(arr, level=PNG_LEVEL)


def _to_png(img_chw: np.ndarray) -> bytes:
    """Encode a [3,H,W] float image to PNG bytes."""
    arr = (np.clip(np.transpose(img_chw, (1, 2, 0)), 0, 1) * 255).astype(
        np.uint8)
    return encode_png(arr, level=PNG_LEVEL)
