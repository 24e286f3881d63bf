"""Browser front end: the analogue of the reference's egui window.

Two views served by the Python stdlib HTTP server, sharing one control panel
that exposes every live control of the reference UI
(``src/bin/main.rs:250-404``) — particle count, world size, update rate,
walls, effect radius, interaction force, drag, repulsion threshold, gravity,
per-species colors, the attraction matrix — plus checkpoint save:

  * ``/``   — server-rendered PNG stream (the on-device splat renderer);
    WASD/QE and arrow keys drive the server camera (main.rs:208-247).
  * ``/gl`` — WebGL position streaming: the server ships raw positions +
    species (``/positions.bin``, ~16 B/particle) and the BROWSER GPU renders
    depth-tested point sprites with a fully client-side camera — the
    structural twin of the reference's CPU-physics/GPU-render split
    (SURVEY.md L2/L1), with the accelerator in the physics seat.

The simulation is advanced by the frame/position requests themselves
(fixed-timestep catch-up in ``SimulationApp.tick``), exactly like the
reference's render-driven loop.

Run: ``python -m particle3d.app.server [--preset reference] [--port 8000]``
"""

from __future__ import annotations

import json
import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

import numpy as np

from .driver import SimulationApp


def encode_png(img) -> bytes:
    """RGB or RGBA uint8 [H, W, C] -> PNG bytes (stdlib ``zlib`` only)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    color_type = {3: 2, 4: 6}[c]
    # each scanline is prefixed with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * c)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))

_STYLE = """<style>
body{margin:0;background:#101014;color:#ccc;font:13px monospace;display:flex}
#panel{width:330px;padding:10px;overflow-y:auto;height:100vh;box-sizing:border-box}
#view{flex:1;display:flex;align-items:center;justify-content:center}
canvas{outline:none}
label{display:block;margin:6px 0 2px}
input[type=range]{width:180px;vertical-align:middle}
input[type=number]{width:70px;background:#222;color:#eee;border:1px solid #444}
table td{padding:1px}
.mat input{width:44px}
#metrics{white-space:pre;color:#8f8}
a{color:#8cf}
button{background:#333;color:#eee;border:1px solid #555;margin:4px 2px;padding:3px 8px}
</style>"""

_PANEL_HTML = """<div id=panel>
  <h3>particle3d</h3>
  <div>{nav}</div>
  <div id=metrics>...</div>
  <label>Particle Count <input id=count type=number step=100></label>
  <label>Simulation Boundary <input id=world type=number step=0.5></label>
  <label>Update Rate (TPS) <input id=tps type=range min=1 max=1000 step=1><span id=tpsv></span></label>
  <label><input id=walls type=checkbox> Use Solid Walls</label>
  <label>Effect Radius <input id=radius type=range min=0.05 max=10 step=0.05><span id=radiusv></span></label>
  <label>Interaction Scale <input id=force type=range min=0 max=10 step=0.1><span id=forcev></span></label>
  <label>Drag (Friction) <input id=drag type=range min=0 max=1 step=0.01><span id=dragv></span></label>
  <label>Repulsion Threshold <input id=minpull type=range min=0 max=1 step=0.01><span id=minpullv></span></label>
  <label>Gravity x <input id=gx type=number step=0.01> y <input id=gy type=number step=0.01> z <input id=gz type=number step=0.01></label>
  <div id=species></div>
  <h4>Attraction Matrix</h4>
  <div class=mat id=matrix></div>
  <button onclick="post('checkpoint',{})">Save checkpoint</button>
  <p>keys: WASD/QE move &middot; arrows rotate (click canvas first)</p>
</div>"""

_PANEL_JS = """
async function post(name,args){await fetch('/control',{method:'POST',
 body:JSON.stringify({name:name,args:args})});}
function bindRange(id,name,fmt){const el=document.getElementById(id),
 v=document.getElementById(id+'v');
 el.oninput=()=>{v.textContent=' '+el.value;post(name,{value:parseFloat(el.value)})};}
bindRange('tps','set_update_rate');bindRange('radius','set_effect_radius');
bindRange('force','set_interaction_force');bindRange('drag','set_drag');
bindRange('minpull','set_min_pull_ratio');
count.onchange=()=>post('set_particle_count',{value:parseInt(count.value)});
world.onchange=()=>post('set_world_size',{value:parseFloat(world.value)});
walls.onchange=()=>post('set_walls',{value:walls.checked});
for(const g of ['gx','gy','gz'])document.getElementById(g).onchange=()=>
 post('set_gravity',{x:parseFloat(gx.value),y:parseFloat(gy.value),z:parseFloat(gz.value)});
function hex(rgb){return '#'+rgb.map(c=>Math.round(c*255).toString(16).padStart(2,'0')).join('')}
function buildPanel(c){
 count.value=c.n;world.value=c.world_size;tps.value=c.update_rate;
 walls.checked=c.walls;radius.value=c.particle_effect_radius;
 force.value=c.interaction_force;drag.value=c.coefficient;minpull.value=c.min_pull_ratio;
 gx.value=c.acceleration[0];gy.value=c.acceleration[1];gz.value=c.acceleration[2];
 let sp='<h4>Species Colors</h4>';
 for(let i=0;i<c.id_count;i++)sp+=`<input type=color value=${hex(c.colors[i])}
  onchange="post('set_color',{species:${i},rgb:this.value})">`;
 document.getElementById('species').innerHTML=sp;
 let m='<table>';
 for(let i=0;i<c.id_count;i++){m+='<tr>';
  for(let j=0;j<c.id_count;j++)m+=`<td><input type=number step=0.1 min=-1 max=1
   value=${c.attraction_matrix[i][j].toFixed(2)}
   onchange="post('set_attraction',{i:${i},j:${j},value:parseFloat(this.value)})"></td>`;
  m+='</tr>'}
 document.getElementById('matrix').innerHTML=m+'</table>';}
async function loadCfg(){cfg=await(await fetch('/config')).json();buildPanel(cfg);return cfg}
"""

_PAGE = ("<!doctype html><html><head><title>particle3d</title>" + _STYLE
         + "</head><body>"
         + _PANEL_HTML.replace("{nav}", '<a href="/gl">switch to WebGL view</a>')
         + """
<div id=view><canvas id=cv width=800 height=600 tabindex=0></canvas></div>
<script>
const cv=document.getElementById('cv'),ctx=cv.getContext('2d');
let cfg=null,keys=new Set(),last=performance.now();
const KEYMAP={KeyW:'w',KeyS:'s',KeyA:'a',KeyD:'d',KeyQ:'q',KeyE:'e',
 ArrowUp:'up',ArrowDown:'down',ArrowLeft:'left',ArrowRight:'right'};
cv.addEventListener('keydown',e=>{if(KEYMAP[e.code]){keys.add(KEYMAP[e.code]);e.preventDefault()}});
cv.addEventListener('keyup',e=>{keys.delete(KEYMAP[e.code])});
""" + _PANEL_JS + """
async function loop(){
 const now=performance.now(),dt=(now-last)/1000;last=now;
 if(keys.size)await post('keys',{keys:[...keys],dt:dt});
 const img=new Image();
 img.onload=()=>{ctx.drawImage(img,0,0);requestAnimationFrame(loop)};
 img.onerror=()=>setTimeout(loop,250);
 img.src='/frame.png?w=800&h=600&t='+now;
 const mdiv=document.getElementById('metrics');
 fetch('/metrics').then(r=>r.json()).then(m=>{
  mdiv.textContent=`FPS: ${(1/dt).toFixed(1)}\\nFrame: ${(dt*1000).toFixed(2)} ms\\n`+
   `Update: ${m.update_ms.toFixed(2)} ms\\nN: ${m.n}  step: ${m.step_index}\\n`+
   `KE: ${m.kinetic_energy.toExponential(3)}`});}
loadCfg().then(()=>loop());
</script></body></html>""")

_PAGE_GL = ("<!doctype html><html><head><title>particle3d (WebGL)</title>"
            + _STYLE + "</head><body>"
            + _PANEL_HTML.replace("{nav}", '<a href="/">switch to PNG view</a>')
            + """
<div id=view><canvas id=cv width=960 height=720 tabindex=0></canvas></div>
<script>
const cv=document.getElementById('cv');
const gl=cv.getContext('webgl2');
let cfg=null,keys=new Set(),last=performance.now();
const KEYMAP={KeyW:'w',KeyS:'s',KeyA:'a',KeyD:'d',KeyQ:'q',KeyE:'e',
 ArrowUp:'up',ArrowDown:'down',ArrowLeft:'left',ArrowRight:'right'};
cv.addEventListener('keydown',e=>{if(KEYMAP[e.code]){keys.add(KEYMAP[e.code]);e.preventDefault()}});
cv.addEventListener('keyup',e=>{keys.delete(KEYMAP[e.code])});
""" + _PANEL_JS + """
// ---- tiny mat4 helpers (column-major) ----
function perspective(fovy,aspect,near,far){const f=1/Math.tan(fovy/2);
 return [f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1,
         0,0,2*far*near/(near-far),0];}
function mul(a,b){const o=new Array(16).fill(0);
 for(let c=0;c<4;c++)for(let r=0;r<4;r++)for(let k=0;k<4;k++)
  o[c*4+r]+=a[k*4+r]*b[c*4+k];return o;}
function view(eye,f,r,u){ // look along f with basis (r,u,-f)
 return [r[0],u[0],-f[0],0, r[1],u[1],-f[1],0, r[2],u[2],-f[2],0,
  -(r[0]*eye[0]+r[1]*eye[1]+r[2]*eye[2]),
  -(u[0]*eye[0]+u[1]*eye[1]+u[2]*eye[2]),
   (f[0]*eye[0]+f[1]*eye[1]+f[2]*eye[2]),1];}
// ---- client-side camera (reference semantics: SPEED=5, 90 deg/s) ----
let cam={pos:[0,0,0],yaw:0,pitch:0};
function axes(){const cy=Math.cos(cam.yaw),sy=Math.sin(cam.yaw),
 cp=Math.cos(cam.pitch),sp=Math.sin(cam.pitch);
 const f=[sy*cp,sp,-cy*cp],r=[cy,0,sy],
 u=[r[1]*f[2]-r[2]*f[1],r[2]*f[0]-r[0]*f[2],r[0]*f[1]-r[1]*f[0]];
 return [f,r,[-u[0],-u[1],-u[2]]];}
function stepCam(dt){const [f,r,u]=axes(),S=5*dt,R=Math.PI/2*dt;
 const mv=(v,s)=>{cam.pos[0]+=v[0]*s;cam.pos[1]+=v[1]*s;cam.pos[2]+=v[2]*s};
 if(keys.has('w'))mv(f,S); if(keys.has('s'))mv(f,-S);
 if(keys.has('d'))mv(r,S); if(keys.has('a'))mv(r,-S);
 if(keys.has('e'))mv(u,S); if(keys.has('q'))mv(u,-S);
 if(keys.has('left'))cam.yaw-=R; if(keys.has('right'))cam.yaw+=R;
 if(keys.has('up'))cam.pitch=Math.min(cam.pitch+R,1.569);
 if(keys.has('down'))cam.pitch=Math.max(cam.pitch-R,-1.569);}
// ---- GL setup ----
function shader(type,src){const s=gl.createShader(type);gl.shaderSource(s,src);
 gl.compileShader(s);if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
 throw gl.getShaderInfoLog(s);return s;}
function program(vs,fs){const p=gl.createProgram();
 gl.attachShader(p,shader(gl.VERTEX_SHADER,vs));
 gl.attachShader(p,shader(gl.FRAGMENT_SHADER,fs));
 gl.linkProgram(p);if(!gl.getProgramParameter(p,gl.LINK_STATUS))
 throw gl.getProgramInfoLog(p);return p;}
const PVS=`#version 300 es
layout(location=0) in vec3 pos; layout(location=1) in float sp;
uniform mat4 u_mvp; uniform float u_focal; out float vsp;
void main(){vec4 cp=u_mvp*vec4(pos,1.0);gl_Position=cp;vsp=sp;
 gl_PointSize=clamp(u_focal*0.05/max(cp.w,0.001),1.5,24.0);}`;
const PFS=`#version 300 es
precision mediump float; in float vsp; out vec4 o; uniform vec3 u_colors[16];
void main(){vec2 c=gl_PointCoord*2.0-1.0; if(dot(c,c)>1.0) discard;
 o=vec4(u_colors[int(vsp+0.5)],1.0);}`;
const LVS=`#version 300 es
layout(location=0) in vec3 pos; uniform mat4 u_mvp;
void main(){gl_Position=u_mvp*vec4(pos,1.0);}`;
const LFS=`#version 300 es
precision mediump float; out vec4 o; void main(){o=vec4(0.6,0.6,0.6,1.0);}`;
const pprog=program(PVS,PFS),lprog=program(LVS,LFS);
const posBuf=gl.createBuffer(),spBuf=gl.createBuffer(),boxBuf=gl.createBuffer();
gl.enable(gl.DEPTH_TEST);gl.clearColor(0.02,0.02,0.03,1);
let nPts=0,boxW=0;
function setBox(w){boxW=w;const h=w/2,V=[];
 const C=[[-h,-h,-h],[h,-h,-h],[-h,h,-h],[h,h,-h],[-h,-h,h],[h,-h,h],[-h,h,h],[h,h,h]];
 const E=[[0,1],[2,3],[4,5],[6,7],[0,2],[1,3],[4,6],[5,7],[0,4],[1,5],[2,6],[3,7]];
 for(const [a,b] of E){V.push(...C[a],...C[b]);}
 gl.bindBuffer(gl.ARRAY_BUFFER,boxBuf);
 gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(V),gl.STATIC_DRAW);}
async function fetchPositions(){
 const buf=await(await fetch('/positions.bin?t='+performance.now())).arrayBuffer();
 const n=new Int32Array(buf,0,1)[0],w=new Float32Array(buf,4,1)[0];
 const pos=new Float32Array(buf,8,n*3);
 const sp=new Float32Array(new Uint8Array(buf,8+n*12,n));
 if(w!==boxW)setBox(w);
 if(cam.pos[0]===0&&cam.pos[1]===0&&cam.pos[2]===0)cam.pos=[0,0,w*1.6];
 gl.bindBuffer(gl.ARRAY_BUFFER,posBuf);
 gl.bufferData(gl.ARRAY_BUFFER,pos,gl.DYNAMIC_DRAW);
 gl.bindBuffer(gl.ARRAY_BUFFER,spBuf);
 gl.bufferData(gl.ARRAY_BUFFER,sp,gl.DYNAMIC_DRAW);
 nPts=n;}
function draw(){
 const [f,r,u]=axes();
 const mvp=mul(perspective(Math.PI/2,cv.width/cv.height,0.001,1000),
               view(cam.pos,f,r,[-u[0],-u[1],-u[2]]));
 gl.viewport(0,0,cv.width,cv.height);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.useProgram(lprog);
 gl.uniformMatrix4fv(gl.getUniformLocation(lprog,'u_mvp'),false,mvp);
 gl.bindBuffer(gl.ARRAY_BUFFER,boxBuf);
 gl.enableVertexAttribArray(0);gl.vertexAttribPointer(0,3,gl.FLOAT,false,0,0);
 gl.disableVertexAttribArray(1);
 gl.drawArrays(gl.LINES,0,24);
 if(nPts){gl.useProgram(pprog);
  gl.uniformMatrix4fv(gl.getUniformLocation(pprog,'u_mvp'),false,mvp);
  gl.uniform1f(gl.getUniformLocation(pprog,'u_focal'),cv.height);
  const cols=new Float32Array(48);
  for(let i=0;i<Math.min(16,cfg.id_count);i++)cols.set(cfg.colors[i],i*3);
  gl.uniform3fv(gl.getUniformLocation(pprog,'u_colors'),cols);
  gl.bindBuffer(gl.ARRAY_BUFFER,posBuf);
  gl.enableVertexAttribArray(0);gl.vertexAttribPointer(0,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,spBuf);
  gl.enableVertexAttribArray(1);gl.vertexAttribPointer(1,1,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.POINTS,0,nPts);}}
async function loop(){
 const now=performance.now(),dt=(now-last)/1000;last=now;
 stepCam(dt);
 try{await fetchPositions();}catch(e){setTimeout(loop,250);return;}
 draw();
 const mdiv=document.getElementById('metrics');
 fetch('/metrics').then(r=>r.json()).then(m=>{
  mdiv.textContent=`FPS: ${(1/dt).toFixed(1)}  (WebGL)\\n`+
   `Update: ${m.update_ms.toFixed(2)} ms\\nN: ${m.n}  step: ${m.step_index}\\n`+
   `KE: ${m.kinetic_energy.toExponential(3)}`});
 requestAnimationFrame(loop);}
loadCfg().then(()=>loop());
</script></body></html>""")


class _Handler(BaseHTTPRequestHandler):
    app: SimulationApp = None
    lock: threading.Lock = None

    def log_message(self, *a):  # quiet
        pass

    def _send(self, code, body, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        url = urlparse(self.path)
        if url.path == "/":
            self._send(200, _PAGE.encode(), "text/html")
        elif url.path == "/gl":
            self._send(200, _PAGE_GL.encode(), "text/html")
        elif url.path == "/positions.bin":
            # binary position stream for the WebGL view: [n i32][world f32]
            # [positions f32 n*3][species u8 n] — ~16 B/particle, the wire
            # analogue of the reference's encase particle upload
            # (src/bin/main.rs:440-457)
            with self.lock:
                self.app.tick()
                pos = np.ascontiguousarray(
                    np.asarray(self.app.state.positions), np.float32)
                spec = np.ascontiguousarray(
                    np.asarray(self.app.state.species), np.uint8)
                w = float(np.asarray(self.app.cfg.world_size))
            body = (np.array([pos.shape[0]], np.int32).tobytes()
                    + np.array([w], np.float32).tobytes()
                    + pos.tobytes() + spec.tobytes())
            self._send(200, body, "application/octet-stream")
        elif url.path == "/frame.png":
            q = parse_qs(url.query)
            w = int(q.get("w", ["640"])[0])
            h = int(q.get("h", ["480"])[0])
            with self.lock:
                self.app.tick()
                img = self.app.render(w, h)
            self._send(200, encode_png(img), "image/png")
        elif url.path == "/metrics":
            with self.lock:
                m = self.app.metrics()
            self._send(200, json.dumps(m).encode())
        elif url.path == "/config":
            with self.lock:
                cfg = self.app.cfg
                out = {
                    "n": self.app.state.n,
                    "world_size": float(np.asarray(cfg.world_size)),
                    "update_rate": self.app.update_rate,
                    "walls": cfg.walls,
                    "particle_effect_radius": float(np.asarray(cfg.particle_effect_radius)),
                    "interaction_force": float(np.asarray(cfg.interaction_force)),
                    "coefficient": float(np.asarray(cfg.coefficient)),
                    "min_pull_ratio": float(np.asarray(cfg.min_pull_ratio)),
                    "acceleration": np.asarray(cfg.acceleration).tolist(),
                    "id_count": cfg.id_count,
                    "colors": np.asarray(cfg.colors).tolist(),
                    "attraction_matrix": np.asarray(cfg.attraction_matrix).tolist(),
                }
            self._send(200, json.dumps(out).encode())
        else:
            self._send(404, b"{}")

    def do_POST(self):
        if self.path != "/control":
            self._send(404, b"{}")
            return
        n = int(self.headers.get("Content-Length", "0"))
        try:
            req = json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError as e:
            self._send(400, json.dumps({"error": f"invalid JSON: {e}"}).encode())
            return
        name, args = req.get("name"), req.get("args", {})
        with self.lock:
            try:
                self._dispatch(name, args)
                self._send(200, b'{"ok": true}')
            except KeyError as e:
                self._send(400, json.dumps(
                    {"error": f"missing argument {e} for {name!r}"}).encode())
            except Exception as e:  # surface config errors to the UI
                self._send(400, json.dumps({"error": str(e)}).encode())

    def _dispatch(self, name, args):
        app = self.app
        if name == "keys":
            app.handle_keys(set(args["keys"]), float(args["dt"]))
        elif name == "set_gravity":
            app.set_gravity(args["x"], args["y"], args["z"])
        elif name == "set_color":
            rgb = args["rgb"]
            if isinstance(rgb, str):  # '#rrggbb'
                rgb = [int(rgb[i:i + 2], 16) / 255.0 for i in (1, 3, 5)]
            app.set_color(int(args["species"]), rgb)
        elif name == "set_attraction":
            app.set_attraction(int(args["i"]), int(args["j"]), args["value"])
        elif name == "checkpoint":
            app.save("checkpoint.npz")
        elif name in ("set_particle_count", "set_world_size", "set_update_rate",
                      "set_walls", "set_effect_radius", "set_interaction_force",
                      "set_drag", "set_min_pull_ratio"):
            getattr(app, name)(args["value"])
        else:
            raise ValueError(f"unknown control {name!r}")


def serve(app: SimulationApp, port: int = 8000, host: str = "127.0.0.1"):
    _Handler.app = app
    _Handler.lock = threading.Lock()
    httpd = ThreadingHTTPServer((host, port), _Handler)
    print(f"particle3d UI on http://{host}:{port}")
    httpd.serve_forever()


def main(argv=None):
    import argparse

    from ..models import make_scene
    from ..utils.cache import configure_compile_cache

    configure_compile_cache()

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="reference")
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    a = p.parse_args(argv)
    state, cfg, dt = make_scene(a.preset, n=a.n)
    app = SimulationApp(state=state, cfg=cfg, update_rate=1.0 / dt)
    serve(app, a.port, a.host)


if __name__ == "__main__":
    main()
