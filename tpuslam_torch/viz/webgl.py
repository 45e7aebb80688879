"""Interactive point-cloud viewer — full capability equivalent of the
reference's OpenGL renderer (``renderer.cpp:1-545``, ``camera.cpp``,
``moveablecamera.cpp``, ``Icosphere.cpp``), re-designed for a headless
TPU host: a **single self-contained HTML file** with a hand-written
WebGL viewer.  No GL context, window system, or network access is needed
where the registration runs; the artifact opens in any browser.

Observable parity with the reference renderer:

* four toggleable clouds with the reference's colors and key bindings —
  ``1``..``4`` toggle before=red, after=green, transformed=yellow,
  origin=blue (``renderer.cpp:128-155``, color table ``:440-450``);
* movable camera — WASD + Space/LeftShift fly with mouse look, exactly
  the reference's control set (``renderer.cpp:91-101``,
  ``moveablecamera.cpp``), plus drag-orbit/wheel-zoom (a browser-native
  improvement, not a regression);
* ``[`` / ``]`` shrink/grow the rendered point size
  (``renderer.cpp:103-111``);
* Phong-shaded spheres: the reference instances an icosphere mesh per
  point (``renderer.cpp:48``); here each point is a screen-space sphere
  *impostor* (normal reconstructed per fragment, same diffuse+specular
  model, ``shaders/*.frag`` equivalent) — visually equivalent at a
  fraction of the geometry cost, which is what lets a browser pan
  through 10^6 points;
* sky-blue clear color (0.5, 0.8, 0.95 — ``renderer.cpp:360``), white
  light, camera starting on the +X axis at 1.5x the cloud scale
  (``renderer.cpp:41``).

A numpy-only copy of ``tpuslam/viz/webgl.py``, which writes the same
bytes (``tests/test_torch_front.py``): importing the original runs
``tpuslam/__init__.py``, which imports JAX.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Optional

import numpy as np

MAX_POINTS_EMBED = 400_000  # per cloud; stride-subsampled beyond this

_COLORS = {
    "before": (1.0, 0.0, 0.0),
    "after": (0.0, 1.0, 0.0),
    "transformed": (1.0, 1.0, 0.0),
    "origin": (0.0, 0.0, 1.0),
}

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tpuslam registration</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#7fcbf2}
 canvas{width:100%;height:100%;display:block}
 #hud{position:fixed;left:10px;top:10px;color:#103;font:13px monospace;
      background:rgba(255,255,255,.75);padding:8px 10px;border-radius:6px;
      user-select:none;white-space:pre}
</style></head><body>
<canvas id="c"></canvas><div id="hud"></div>
<script>
"use strict";
const DATA = __DATA__;
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias:true});
if (!gl) document.body.textContent = "WebGL unavailable";

const VS = `
attribute vec3 aPos;
uniform mat4 uView, uProj;
uniform float uSize, uVH;
varying vec3 vEye;
void main(){
  vec4 eye = uView * vec4(aPos,1.0);
  vEye = eye.xyz;
  gl_Position = uProj * eye;
  gl_PointSize = clamp(uSize * uVH / max(-eye.z, 1e-3), 1.0, 256.0);
}`;
const FS = `
precision mediump float;
uniform vec3 uColor;
varying vec3 vEye;
void main(){
  vec2 p = gl_PointCoord*2.0 - 1.0;
  float r2 = dot(p,p);
  if (r2 > 1.0) discard;
  vec3 n = vec3(p.x, -p.y, sqrt(1.0 - r2));
  vec3 l = normalize(-vEye);               // white headlight
  float diff = max(dot(n,l), 0.0);
  float spec = pow(max(n.z, 0.0), 32.0) * 0.35;
  vec3 c = uColor * (0.25 + 0.75*diff) + vec3(spec);
  gl_FragColor = vec4(c, 1.0);
}`;
function shader(type, src){
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  if(!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const loc = {
  aPos: gl.getAttribLocation(prog, "aPos"),
  uView: gl.getUniformLocation(prog, "uView"),
  uProj: gl.getUniformLocation(prog, "uProj"),
  uSize: gl.getUniformLocation(prog, "uSize"),
  uVH: gl.getUniformLocation(prog, "uVH"),
  uColor: gl.getUniformLocation(prog, "uColor"),
};

function decode(b64){
  const bin = atob(b64), n = bin.length;
  const bytes = new Uint8Array(n);
  for (let i=0;i<n;i++) bytes[i] = bin.charCodeAt(i);
  return new Float32Array(bytes.buffer);
}
const clouds = [];   // reference toggle order: renderer.cpp:128-155
let lo=[1/0,1/0,1/0], hi=[-1/0,-1/0,-1/0];
for (const c of DATA.clouds){
  const pts = decode(c.b64);
  const buf = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, buf);
  gl.bufferData(gl.ARRAY_BUFFER, pts, gl.STATIC_DRAW);
  for (let i=0;i<pts.length;i+=3) for (let k=0;k<3;k++){
    lo[k]=Math.min(lo[k],pts[i+k]); hi[k]=Math.max(hi[k],pts[i+k]);
  }
  clouds.push({name:c.name, color:c.color, n:pts.length/3, buf:buf,
               visible:true, key:String(clouds.length+1)});
}
const center=[0,1,2].map(k=>(lo[k]+hi[k])/2);
const scale=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1e-6);

// camera: orbit (drag / wheel) + WASD-Space-Shift fly (renderer.cpp:91-101)
let yaw=0, pitch=0, dist=1.5*scale, pan=[0,0,0];
let pointSize=DATA.point_size*0.01;      // world-units radius knob
const keys={};
function viewMatrix(){
  const cy=Math.cos(yaw), sy=Math.sin(yaw);
  const cp=Math.cos(pitch), sp=Math.sin(pitch);
  // camera starts on +X at 1.5*scale, like SetCamera(1.5*scale,0,0)
  const fwd=[-cy*cp, -sp, -sy*cp];
  const eye=[center[0]+pan[0]-fwd[0]*dist,
             center[1]+pan[1]-fwd[1]*dist,
             center[2]+pan[2]-fwd[2]*dist];
  const zx=-fwd[0], zy=-fwd[1], zz=-fwd[2];
  // right = up x z with up=[0,1,0]
  let rx=[1*zz-0*zy, 0*zx-0*zz, 0*zy-1*zx];
  const rl=Math.hypot(rx[0],rx[1],rx[2]); rx=rx.map(v=>v/rl);
  const ux=[zy*rx[2]-zz*rx[1], zz*rx[0]-zx*rx[2], zx*rx[1]-zy*rx[0]];
  return [rx[0],ux[0],zx,0, rx[1],ux[1],zy,0, rx[2],ux[2],zz,0,
          -(rx[0]*eye[0]+rx[1]*eye[1]+rx[2]*eye[2]),
          -(ux[0]*eye[0]+ux[1]*eye[1]+ux[2]*eye[2]),
          -(zx*eye[0]+zy*eye[1]+zz*eye[2]), 1];
}
function projMatrix(aspect){
  const f=1/Math.tan(Math.PI/8), near=scale*1e-3, far=scale*100;
  return [f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1,
          0,0,2*far*near/(near-far),0];
}
canvas.addEventListener("mousedown", e=>{drag={x:e.clientX,y:e.clientY,b:e.button};});
let drag=null;
window.addEventListener("mouseup", ()=>drag=null);
window.addEventListener("mousemove", e=>{
  if(!drag) return;
  const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
  drag.x=e.clientX; drag.y=e.clientY;
  if (drag.b===2){ // right-drag pan
    const s=dist*0.0015;
    pan[0]+=(-dx*Math.sin(yaw))*s; pan[2]+=(dx*Math.cos(yaw))*s; pan[1]+=dy*s;
  } else { yaw+=dx*0.005; pitch=Math.max(-1.55,Math.min(1.55,pitch+dy*0.005)); }
});
canvas.addEventListener("contextmenu", e=>e.preventDefault());
canvas.addEventListener("wheel", e=>{
  dist*=Math.exp(e.deltaY*0.001); e.preventDefault();
},{passive:false});
window.addEventListener("keydown", e=>{
  keys[e.key.toLowerCase()]=true; keys[e.code]=true;
  const c = clouds.find(c=>c.key===e.key);
  if (c){ c.visible=!c.visible; hud(); }
  if (e.key==="]") { pointSize*=1.1; hud(); }
  if (e.key==="[") { pointSize=Math.max(pointSize/1.1, 1e-4*scale); hud(); }
});
window.addEventListener("keyup", e=>{keys[e.key.toLowerCase()]=false; keys[e.code]=false;});

function hud(){
  document.getElementById("hud").textContent =
    clouds.map(c=>`[${c.key}] ${c.name} (${c.n} pts) ${c.visible?"on":"off"}`)
      .join("\\n") +
    "\\ndrag orbit / right-drag pan / wheel zoom / WASD+Space+Shift fly" +
    "\\n[ ] point size: " + pointSize.toExponential(2);
}
hud();

let tPrev=performance.now();
function frame(t){
  const dt=(t-tPrev)/1000; tPrev=t;
  const v=scale*0.5*dt;
  // WASD fly moves the orbit target — reference MoveableCamera
  // semantics (renderer.cpp:91-101); fwd matches viewMatrix's -Z
  const fwd=[-Math.cos(yaw)*Math.cos(pitch), -Math.sin(pitch),
             -Math.sin(yaw)*Math.cos(pitch)];
  const right=[-fwd[2], 0, fwd[0]];
  if (keys["w"]) {pan[0]+=fwd[0]*v; pan[1]+=fwd[1]*v; pan[2]+=fwd[2]*v;}
  if (keys["s"]) {pan[0]-=fwd[0]*v; pan[1]-=fwd[1]*v; pan[2]-=fwd[2]*v;}
  if (keys["a"]) {pan[0]-=right[0]*v; pan[2]-=right[2]*v;}
  if (keys["d"]) {pan[0]+=right[0]*v; pan[2]+=right[2]*v;}
  if (keys[" "]) pan[1]+=v;
  if (keys["ShiftLeft"]) pan[1]-=v;

  const w=canvas.clientWidth*devicePixelRatio,
        h=canvas.clientHeight*devicePixelRatio;
  if (canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h;}
  gl.viewport(0,0,w,h);
  gl.clearColor(0.5,0.8,0.95,1);     // renderer.cpp:360
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(loc.uView,false,viewMatrix());
  gl.uniformMatrix4fv(loc.uProj,false,projMatrix(w/h));
  gl.uniform1f(loc.uSize, pointSize);
  gl.uniform1f(loc.uVH, h/(2*Math.tan(Math.PI/8)));
  for (const c of clouds){
    if (!c.visible) continue;
    gl.bindBuffer(gl.ARRAY_BUFFER, c.buf);
    gl.enableVertexAttribArray(loc.aPos);
    gl.vertexAttribPointer(loc.aPos,3,gl.FLOAT,false,0,0);
    gl.uniform3fv(loc.uColor, c.color);
    gl.drawArrays(gl.POINTS,0,c.n);
  }
  requestAnimationFrame(frame);
}
requestAnimationFrame(frame);
</script></body></html>
"""


def _sub(cloud: np.ndarray) -> np.ndarray:
    if len(cloud) <= MAX_POINTS_EMBED:
        return cloud
    step = len(cloud) // MAX_POINTS_EMBED + 1
    return cloud[::step]


def export_html(
    before: Optional[np.ndarray] = None,
    after: Optional[np.ndarray] = None,
    transformed: Optional[np.ndarray] = None,
    origin: Optional[np.ndarray] = None,
    path: str = "registration.html",
    point_size: float = 0.3,
) -> str:
    """Write the self-contained interactive viewer; returns the path.

    ``point_size`` follows the reference default (``renderer.cpp:37``).
    Cloud order fixes the 1..4 toggle keys to the reference's color
    order red/green/yellow/blue (``renderer.cpp:440-450``)."""
    clouds = []
    for name, cloud in (
        ("before", before),
        ("after", after),
        ("transformed", transformed),
        ("origin", origin),
    ):
        if cloud is None or len(cloud) == 0:
            continue
        pts = np.ascontiguousarray(
            _sub(np.asarray(cloud, np.float32)), dtype=np.float32
        )
        clouds.append({
            "name": name,
            "color": list(_COLORS[name]),
            "b64": base64.b64encode(pts.tobytes()).decode("ascii"),
        })
    data = {"clouds": clouds, "point_size": point_size * 100.0}
    html = _HTML.replace("__DATA__", json.dumps(data))
    with open(path, "w") as f:
        f.write(html)
    print(f"Interactive visualization saved to {os.path.abspath(path)}")
    return path
