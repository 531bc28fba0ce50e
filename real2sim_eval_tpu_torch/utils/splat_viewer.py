"""Client-side (in-browser WebGL2) gaussian-splat viewer (the JAX
package's utils/splat_viewer.py).

The reference inspects scans with a browser-rendered splat widget
(sim/utils/gs/gs_processor.py:249-289 ``visualize_gs``: .splat export +
gradio ``Model3D``, which renders client-side WebGL in the user's
browser). This module writes the .splat file(s) through
``GSProcessor.save_to_splat`` plus one self-contained HTML page embedding
a WebGL2 splat renderer (the JAX package's page, byte for byte), and
serves the directory over plain ``http.server``. All rendering happens in
the browser; nothing here touches the card.

Renderer design (standalone JS):
  - splat data packed into one RGBA32UI texel-fetch texture (8 u32 per
    splat: 3f pos, 3f scale, u8x4 rgba, u8x4 quat — the .splat layout);
  - per-frame JS depth sort (16-bit counting sort) uploads ONLY the
    4-byte instance index array;
  - vertex shader rebuilds the 3D covariance from scale+quat, projects
    the EWA 2D covariance (same math as renderer/preprocess.py), emits
    a 2-sigma-eigen quad per instance;
  - fragment shader evaluates the gaussian falloff, premultiplied
    back-to-front alpha blending.

Usage:
  python -m real2sim_eval_tpu_torch.utils.splat_viewer scan1.ply [scan2.ply ...]
      [--merged] [--axis] [--transform] [--port 6791] [--out-dir D] [--no-serve]
"""

from __future__ import annotations

import http.server
import json
import tempfile
from pathlib import Path

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
 html,body{margin:0;height:100%;overflow:hidden;background:#111;color:#ddd;
  font:12px monospace}
 canvas{width:100%;height:100%;display:block}
 #hud{position:fixed;left:8px;top:8px;pointer-events:none;white-space:pre}
</style></head><body>
<canvas id="c"></canvas><div id="hud">loading...</div>
<script>
"use strict";
const FILES = __FILES__;
const VS = `#version 300 es
precision highp float; precision highp usampler2D;
layout(location=0) in vec2 corner;      // quad corner in [-1,1]^2
layout(location=1) in uint sid;         // sorted splat id
uniform usampler2D dat; uniform mat4 view; uniform vec2 focal, half_wh;
out vec4 v_col; out vec2 v_xy;
void main(){
  int w = textureSize(dat,0).x; int row = int(sid)*2;
  uvec4 a = texelFetch(dat, ivec2(row%w, row/w), 0);
  uvec4 b = texelFetch(dat, ivec2((row+1)%w, (row+1)/w), 0);
  vec3 p = vec3(uintBitsToFloat(a.x),uintBitsToFloat(a.y),uintBitsToFloat(a.z));
  vec3 s = vec3(uintBitsToFloat(a.w),uintBitsToFloat(b.x),uintBitsToFloat(b.y));
  uint cu = b.z, qu = b.w;
  vec4 col = vec4(float(cu&255u),float((cu>>8)&255u),float((cu>>16)&255u),
                  float((cu>>24)&255u))/255.0;
  vec4 q = (vec4(float(qu&255u),float((qu>>8)&255u),float((qu>>16)&255u),
                 float((qu>>24)&255u))-128.0)/128.0;   // wxyz
  q = normalize(q);
  float r=q.x,x=q.y,y=q.z,z=q.w;
  mat3 R = mat3(1.-2.*(y*y+z*z), 2.*(x*y+r*z), 2.*(x*z-r*y),
                2.*(x*y-r*z), 1.-2.*(x*x+z*z), 2.*(y*z+r*x),
                2.*(x*z+r*y), 2.*(y*z-r*x), 1.-2.*(x*x+y*y));
  mat3 S = mat3(s.x,0,0, 0,s.y,0, 0,0,s.z);
  mat3 M = R*S; mat3 V = M*transpose(M);          // 3D covariance
  vec4 cam4 = view*vec4(p,1.0); vec3 cam = cam4.xyz;
  if (cam.z < 0.05){ gl_Position = vec4(0,0,2,1); return; }
  float iz = 1.0/cam.z;
  mat3 J = mat3(focal.x*iz, 0, 0,
                0, focal.y*iz, 0,
                -focal.x*cam.x*iz*iz, -focal.y*cam.y*iz*iz, 0);
  mat3 W = mat3(view);                            // rotation part
  mat3 T = J*W;
  mat3 C = T*V*transpose(T);
  float cxx = C[0][0]+0.3, cyy = C[1][1]+0.3, cxy = C[0][1];
  float tr = cxx+cyy, det = cxx*cyy-cxy*cxy;
  float l1 = 0.5*tr + sqrt(max(0.25*tr*tr-det,1e-8));
  float l2 = 0.5*tr - sqrt(max(0.25*tr*tr-det,1e-8));
  vec2 e1 = normalize(vec2(cxy, l1-cxx)); if (abs(cxy)<1e-8) e1=vec2(1,0);
  vec2 e2 = vec2(-e1.y, e1.x);
  float k = 3.0;                                  // 3-sigma quad
  vec2 d = corner.x*e1*k*sqrt(max(l1,1e-8))
         + corner.y*e2*k*sqrt(max(l2,1e-8));
  vec2 px = vec2(focal.x*cam.x*iz, focal.y*cam.y*iz) + d;
  gl_Position = vec4(px/half_wh, 0.0, 1.0);
  gl_Position.y *= -1.0;
  v_col = col; v_xy = corner*k;
}`;
const FS = `#version 300 es
precision highp float;
in vec4 v_col; in vec2 v_xy; out vec4 o;
void main(){
  float r2 = dot(v_xy,v_xy);
  float a = v_col.a*exp(-0.5*r2);
  if (a < 0.00392) discard;
  o = vec4(v_col.rgb*a, a);                        // premultiplied
}`;
const cv = document.getElementById('c'), hud = document.getElementById('hud');
const gl = cv.getContext('webgl2', {antialias:false});
function sh(t,s){const h=gl.createShader(t);gl.shaderSource(h,s);
 gl.compileShader(h);
 if(!gl.getShaderParameter(h,gl.COMPILE_STATUS))
   throw gl.getShaderInfoLog(h); return h;}
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER,VS));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog); gl.useProgram(prog);
gl.disable(gl.DEPTH_TEST); gl.enable(gl.BLEND);
gl.blendFunc(gl.ONE, gl.ONE_MINUS_SRC_ALPHA);     // back-to-front premult

let N=0, pos=null, idxBuf, datTex;
const quad = new Float32Array([-1,-1, 1,-1, -1,1, 1,1]);
const qb = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, qb);
gl.bufferData(gl.ARRAY_BUFFER, quad, gl.STATIC_DRAW);
gl.enableVertexAttribArray(0);
gl.vertexAttribPointer(0,2,gl.FLOAT,false,0,0);
idxBuf = gl.createBuffer();
gl.enableVertexAttribArray(1);

async function load(){
  const bufs=[];
  for (const f of FILES){
    const r = await fetch(f); bufs.push(await r.arrayBuffer());
  }
  const total = bufs.reduce((n,b)=>n+b.byteLength,0);
  const all = new Uint8Array(total);
  let off=0; for(const b of bufs){all.set(new Uint8Array(b),off);off+=b.byteLength;}
  N = total>>5;
  const u32 = new Uint32Array(all.buffer);
  pos = new Float32Array(all.buffer);
  const w = 2048, h = Math.ceil(N*2/w);
  const tex = new Uint32Array(w*h*4);
  tex.set(u32);
  datTex = gl.createTexture();
  gl.activeTexture(gl.TEXTURE0);
  gl.bindTexture(gl.TEXTURE_2D, datTex);
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_MIN_FILTER,gl.NEAREST);
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_MAG_FILTER,gl.NEAREST);
  gl.texImage2D(gl.TEXTURE_2D,0,gl.RGBA32UI,w,h,0,gl.RGBA_INTEGER,
                gl.UNSIGNED_INT,tex);
  gl.uniform1i(gl.getUniformLocation(prog,'dat'),0);
  hud.textContent = N+' splats  drag=orbit wheel=zoom shift-drag=pan';
  sortAndDraw();
}
// camera state: orbit around target
let theta=0.6, phi=1.1, dist=2.5, target=[0,0,0];
function viewMat(){
  const ct=Math.cos(theta),st=Math.sin(theta);
  const cp=Math.cos(phi),sp=Math.sin(phi);
  const eye=[target[0]+dist*sp*ct, target[1]+dist*cp, target[2]+dist*sp*st];
  const f=norm3(sub3(target,eye)), r=norm3(cross3(f,[0,1,0])),
        u=cross3(r,f);
  // world->cam with +z forward
  return {m:new Float32Array([
    r[0],u[0],f[0],0, r[1],u[1],f[1],0, r[2],u[2],f[2],0,
    -dot3(r,eye),-dot3(u,eye),-dot3(f,eye),1]), eye};
}
function sub3(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function cross3(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
                             a[0]*b[1]-a[1]*b[0]];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;
 return [a[0]/l,a[1]/l,a[2]/l];}

let order=null, depths=null, counts=null, starts=null;
function sortSplats(vm){
  if(!order||order.length!==N){order=new Uint32Array(N);
    depths=new Uint32Array(N);counts=new Uint32Array(65536);
    starts=new Uint32Array(65536);}
  counts.fill(0);
  const zx=vm[2],zy=vm[6],zz=vm[10],zw=vm[14];
  let mn=Infinity,mx=-Infinity;
  for(let i=0;i<N;i++){
    const o=i*8;
    const d=zx*pos[o]+zy*pos[o+1]+zz*pos[o+2]+zw;
    depths[i]=d*1000|0; if(depths[i]<mn)mn=depths[i];
    if(depths[i]>mx)mx=depths[i];
  }
  const span=Math.max(mx-mn,1);
  for(let i=0;i<N;i++){
    const b=65535-(((depths[i]-mn)*65535/span)|0);  // far first
    depths[i]=b; counts[b]++;
  }
  let acc=0;for(let b=0;b<65536;b++){starts[b]=acc;acc+=counts[b];}
  for(let i=0;i<N;i++) order[starts[depths[i]]++]=i;
  gl.bindBuffer(gl.ARRAY_BUFFER, idxBuf);
  gl.bufferData(gl.ARRAY_BUFFER, order, gl.DYNAMIC_DRAW);
  gl.vertexAttribIPointer(1,1,gl.UNSIGNED_INT,0,0);
  gl.vertexAttribDivisor(1,1);
}
function sortAndDraw(){
  const dpr=window.devicePixelRatio||1;
  cv.width=cv.clientWidth*dpr; cv.height=cv.clientHeight*dpr;
  gl.viewport(0,0,cv.width,cv.height);
  const {m}=viewMat();
  sortSplats(m);
  const fo=0.75*cv.height;                        // ~67deg vertical fov
  gl.uniformMatrix4fv(gl.getUniformLocation(prog,'view'),false,m);
  gl.uniform2f(gl.getUniformLocation(prog,'focal'),fo,fo);
  gl.uniform2f(gl.getUniformLocation(prog,'half_wh'),cv.width/2,cv.height/2);
  gl.clearColor(0.06,0.06,0.07,1); gl.clear(gl.COLOR_BUFFER_BIT);
  gl.drawArraysInstanced(gl.TRIANGLE_STRIP,0,4,N);
}
let dragging=false,panning=false,lx=0,ly=0,pending=false;
function queueDraw(){if(!pending){pending=true;
 requestAnimationFrame(()=>{pending=false;sortAndDraw();});}}
cv.addEventListener('pointerdown',e=>{dragging=true;
 panning=e.shiftKey||e.button===2;lx=e.clientX;ly=e.clientY;});
window.addEventListener('pointerup',()=>dragging=false);
window.addEventListener('pointermove',e=>{
  if(!dragging)return;
  const dx=e.clientX-lx,dy=e.clientY-ly;lx=e.clientX;ly=e.clientY;
  if(panning){
    const {m}=viewMat();
    const s=dist*0.0015;
    target[0]-=(m[0]*dx-m[1]*dy)*s;
    target[1]-=(m[4]*dx-m[5]*dy)*s;
    target[2]-=(m[8]*dx-m[9]*dy)*s;
  } else { theta+=dx*0.005; phi=Math.min(3.1,Math.max(0.05,phi-dy*0.005)); }
  queueDraw();});
cv.addEventListener('wheel',e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.001);queueDraw();},{passive:false});
cv.addEventListener('contextmenu',e=>e.preventDefault());
window.addEventListener('resize',queueDraw);
load();
</script></body></html>
"""


def write_viewer_html(splat_files, out_path, title="splats"):
    """Write the self-contained viewer page next to the .splat files
    (``splat_files`` are paths RELATIVE to the page)."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    html = _HTML.replace("__TITLE__", title).replace(
        "__FILES__", json.dumps([str(f) for f in splat_files]))
    out_path.write_text(html)
    return out_path


def serve_dir(root: Path, port: int = 6791):
    """Serve ``root`` over http (the browser fetches index.html + splats)."""
    root = Path(root)

    class H(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **k):
            super().__init__(*a, directory=str(root), **k)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("0.0.0.0", port), H)
    print(f"client-side splat viewer: http://localhost:{port}/index.html",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass


def visualize_gs(gs_name_list, transform: bool = False, merged: bool = False,
                 axis_on: bool = False, port: int = 6791,
                 out_dir: str | None = None, serve: bool = True):
    """Browser-rendered splat inspection — the reference's ``visualize_gs``
    surface (gs_processor.py:249-289) without gradio: exports .splat
    temp files and one WebGL2 page, serves them, renders CLIENT-side."""
    from .gs_processor import GSProcessor

    proc = GSProcessor()
    root = Path(out_dir) if out_dir else Path(tempfile.mkdtemp(
        prefix="splat_viewer_"))
    root.mkdir(parents=True, exist_ok=True)
    names = []
    if merged:
        params = proc.merge([proc.load(str(n)) for n in gs_name_list])
        if axis_on:
            params = proc.add_axis(params)
        proc.save_to_splat(params, root / "merged.splat", center=transform,
                           rotate=transform)
        names = ["merged.splat"]
    else:
        for n in gs_name_list:
            params = proc.load(str(n))
            if axis_on:
                params = proc.add_axis(params)
            out = f"{Path(n).stem}.splat"
            proc.save_to_splat(params, root / out, center=transform,
                               rotate=transform)
            names.append(out)
    write_viewer_html(names, root / "index.html",
                      title=", ".join(str(n) for n in gs_name_list))
    if serve:
        serve_dir(root, port)
    return root


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="In-browser (client-side WebGL2) splat viewer")
    ap.add_argument("plys", nargs="+")
    ap.add_argument("--merged", action="store_true")
    ap.add_argument("--axis", action="store_true")
    ap.add_argument("--transform", action="store_true",
                    help="center + y-up rotate for web conventions")
    ap.add_argument("--port", type=int, default=6791)
    ap.add_argument("--out-dir", default=None,
                    help="write files here instead of a temp dir")
    ap.add_argument("--no-serve", action="store_true",
                    help="only write the files (for remote copies)")
    args = ap.parse_args(argv)
    visualize_gs(args.plys, transform=args.transform, merged=args.merged,
                 axis_on=args.axis, port=args.port, out_dir=args.out_dir,
                 serve=not args.no_serve)


if __name__ == "__main__":
    main()
