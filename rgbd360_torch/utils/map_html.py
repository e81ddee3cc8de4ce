"""Copy of rgbd360_tpu/utils/map_html.py (numpy only; a keyframe cloud held
as tensors is read back to the host). utils/live_viewer.py serves the
same payload while a SLAM app runs.

Self-contained explorable HTML map viewer — the offline replacement for
the reference's live PCL visualizer (reference include/Map360_Visualizer.h:95-319:
viewer thread drawing the trajectory, keyframe frusta, plane hulls and
loop-closure edges, with keyboard toggles). Here the same elements render in
a single offline .html file (no external assets): a canvas orbit viewer with
drag-rotate / wheel-zoom / right-drag-pan and the reference's toggles as
keys/checkboxes (t trajectory, o optimized, f frusta, p planes, l LC edges,
c cloud).
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np

from rgbd360_torch.utils.viz import host_array


def _frustum_lines(pose: np.ndarray, scale: float = 0.12) -> List[List[float]]:
    """Wireframe pyramid for a keyframe pose (viewer 'camera' glyph,
    Map360_Visualizer.h:214-233 draws a sphere+axes per KF; a frustum reads
    better in 2D projection). Returns a list of 3D segment endpoints."""
    s = scale
    tip = np.array([0.0, 0.0, 0.0])
    corners = np.array(
        [[-s, -s, 1.6 * s], [s, -s, 1.6 * s], [s, s, 1.6 * s], [-s, s, 1.6 * s]]
    )
    pts = np.vstack([tip[None], corners])
    R, t = pose[:3, :3], pose[:3, 3]
    w = pts @ R.T + t
    segs = []
    for c in range(1, 5):
        segs.append([w[0].tolist(), w[c].tolist()])
    for c in range(1, 5):
        segs.append([w[c].tolist(), w[1 + c % 4].tolist()])
    return segs


def build_map_data(
    trajectory: Optional[Sequence[np.ndarray]] = None,
    optimized: Optional[Sequence[np.ndarray]] = None,
    planes: Optional[list] = None,  # dicts {hull: (K,3) list, color, id, area}
    lc_edges: Optional[Sequence] = None,  # (kf_i, kf_j) non-consecutive pairs
    points: Optional[np.ndarray] = None,  # (N,3) world cloud (subsampled)
    point_colors: Optional[np.ndarray] = None,  # (N,3) u8 RGB
    title: str = "rgbd360 map",
) -> dict:
    """The viewer's JSON payload (shared by the offline dump and the live
    viewer's live.json)."""
    trajectory = [np.asarray(p, float) for p in (trajectory or [])]
    optimized = [np.asarray(p, float) for p in (optimized or [])]
    return {
        "title": title,
        "traj": [p[:3, 3].tolist() for p in trajectory],
        "opt": [p[:3, 3].tolist() for p in optimized],
        "frusta": [seg for p in trajectory for seg in _frustum_lines(p)],
        "planes": planes or [],
        "lc": [
            [trajectory[i][:3, 3].tolist(), trajectory[j][:3, 3].tolist()]
            for i, j in (lc_edges or [])
            if i < len(trajectory) and j < len(trajectory)
        ],
        "pts": (np.asarray(points, float).round(4).tolist() if points is not None else []),
        "ptc": (
            np.asarray(point_colors, int).tolist() if point_colors is not None else []
        ),
    }


def write_map_html(path: str, title: str = "rgbd360 map", **kwargs) -> None:
    data = build_map_data(title=title, **kwargs)
    with open(path, "w") as f:
        f.write(render_html(data, title))


def render_html(data: dict, title: str, live_interval_ms: Optional[int] = None) -> str:
    return (
        _TEMPLATE.replace("__TITLE__", title)
        .replace("__DATA__", json.dumps(data, separators=(",", ":")))
        # `is not None`, not truthiness: interval 0 means "poll as fast as
        # possible" (like the neighboring port=0 ephemeral convention), not
        # "render a static page"
        .replace("__LIVE__", "true" if live_interval_ms is not None else "false")
        .replace("__INTERVAL_MS__", str(live_interval_ms if live_interval_ms is not None else 0))
    )


def planes_payload(frames: Sequence, poses: Sequence[np.ndarray]) -> list:
    """World-frame plane-hull payload from per-keyframe rig-frame PbMaps."""
    out = []
    for kf, (frame, pose) in enumerate(zip(frames, poses)):
        pb = getattr(frame, "planes", None)
        if pb is None:
            continue
        R, t = np.asarray(pose, float)[:3, :3], np.asarray(pose, float)[:3, 3]
        for p in pb.planes:
            if p.hull is None or len(p.hull) < 3:
                continue
            # main_color is already RGB: both producers convert from the
            # sensor BGR before averaging (ops/plane_stats.sensor_plane_stats
            # and Plane.compute_colors)
            col = p.main_color if p.main_color is not None else [0.6, 0.6, 0.6]
            rgb = [int(255 * float(c)) for c in np.asarray(col)]
            out.append(
                {
                    "hull": (np.asarray(p.hull, float) @ R.T + t).round(4).tolist(),
                    "color": rgb,
                    "id": f"kf{kf}/p{p.id}",
                    "area": round(float(p.area_hull), 3),
                }
            )
    return out


def map_view_kwargs(world, cloud_stride: int = 0) -> dict:
    """build_map_data/write_map_html kwargs for a Map360 (shared by the
    offline dump and the live viewer)."""
    poses = [np.asarray(p, float) for p in world.trajectory_poses]
    lc = []
    for kf2, conns in world.connection_kfs.items():
        for kf1 in conns:
            if abs(kf2 - kf1) > 1:
                lc.append((kf1, kf2))
    pts = colors = None
    if cloud_stride > 0:
        chunks, cchunks = [], []
        for frame, pose in zip(world.frames, poses):
            sc = getattr(frame, "sphere_cloud", None)
            if sc is None:
                continue
            xyz = np.asarray(host_array(sc[0]), float).reshape(-1, 3)[::cloud_stride]
            rgb = np.asarray(host_array(sc[1])).reshape(-1, 3)[::cloud_stride]
            keep = np.isfinite(xyz).all(axis=-1)
            chunks.append(xyz[keep] @ pose[:3, :3].T + pose[:3, 3])
            cchunks.append(rgb[keep])
        if chunks:
            pts = np.concatenate(chunks)
            colors = np.concatenate(cchunks)
    return dict(
        trajectory=poses,
        optimized=world.optimized_poses,
        planes=planes_payload(world.frames, poses),
        lc_edges=lc,
        points=pts,
        point_colors=colors,
    )


def map_to_html(path: str, world, cloud_stride: int = 0, title: str = "rgbd360 map") -> None:
    """Dump a Map360 as an explorable offline HTML artifact: trajectory,
    optimized trajectory, KF frusta, world-frame plane hulls and
    loop-closure edges (connections between non-consecutive keyframes);
    optionally a subsampled global point cloud (cloud_stride > 0 keeps every
    stride-th point of each KF's sphere cloud)."""
    write_map_html(path, title=title, **map_view_kwargs(world, cloud_stride))


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 html,body{margin:0;height:100%;background:#111;color:#ddd;font:13px sans-serif}
 #c{display:block;width:100%;height:100%}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:8px 10px;
      border-radius:6px;line-height:1.7}
 #hud label{margin-right:10px;cursor:pointer}
 #stat{position:fixed;bottom:8px;left:8px;color:#888}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><b>__TITLE__</b><br/>
 <label><input type="checkbox" id="tg_t" checked>[t]rajectory</label>
 <label><input type="checkbox" id="tg_o" checked>[o]ptimized</label>
 <label><input type="checkbox" id="tg_f" checked>[f]rusta</label><br/>
 <label><input type="checkbox" id="tg_p" checked>[p]lanes</label>
 <label><input type="checkbox" id="tg_l" checked>[l]oop closures</label>
 <label><input type="checkbox" id="tg_c" checked>[c]loud</label>
</div>
<div id="stat"></div>
<script>
let D=__DATA__;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let yaw=-0.6,pitch=-0.45,dist=0,cx=[0,0,0],panX=0,panY=0;
function fitView(){ // fit view to content
 const all=[...D.traj,...D.opt,...D.pts];
 for(const pl of D.planes) all.push(...pl.hull);
 if(!all.length){dist=10;return;}
 const lo=[1/0,1/0,1/0],hi=[-1/0,-1/0,-1/0];
 for(const p of all)for(let i=0;i<3;i++){lo[i]=Math.min(lo[i],p[i]);hi[i]=Math.max(hi[i],p[i]);}
 for(let i=0;i<3;i++)cx[i]=(lo[i]+hi[i])/2;
 dist=2.2*Math.max(1e-3,Math.hypot(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2]));
}
fitView();
function proj(p){
 const x=p[0]-cx[0],y=p[1]-cx[1],z=p[2]-cx[2];
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const x1=cy*x+sy*z, z1=-sy*x+cy*z;
 const y2=cp*y-sp*z1, z2=sp*y+cp*z1+dist;
 if(z2<1e-3)return null;
 const f=0.9*Math.min(cv.width,cv.height);
 return [cv.width/2+f*x1/z2+panX, cv.height/2+f*y2/z2+panY, z2];
}
function polyline(pts,style,w){
 ctx.strokeStyle=style;ctx.lineWidth=w;ctx.beginPath();let pen=false;
 for(const p of pts){const q=proj(p);
  if(!q){pen=false;continue;}
  pen?ctx.lineTo(q[0],q[1]):ctx.moveTo(q[0],q[1]);pen=true;}
 ctx.stroke();
}
function seg(a,b,style,w){polyline([a,b],style,w);}
function on(id){return document.getElementById('tg_'+id).checked;}
function draw(){
 cv.width=innerWidth;cv.height=innerHeight;
 ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
 if(on('c')&&D.pts.length){
  for(let i=0;i<D.pts.length;i++){const q=proj(D.pts[i]);if(!q)continue;
   const c=D.ptc[i]||[160,160,160];
   ctx.fillStyle=`rgb(${c[0]},${c[1]},${c[2]})`;ctx.fillRect(q[0],q[1],2,2);}}
 if(on('p')){
  const polys=[];
  for(const pl of D.planes){
   const q=pl.hull.map(proj);if(q.some(v=>!v))continue;
   polys.push([q.reduce((s,v)=>s+v[2],0)/q.length,q,pl.color]);}
  polys.sort((a,b)=>b[0]-a[0]);
  for(const[_,q,c]of polys){
   ctx.beginPath();ctx.moveTo(q[0][0],q[0][1]);
   for(let i=1;i<q.length;i++)ctx.lineTo(q[i][0],q[i][1]);
   ctx.closePath();
   ctx.fillStyle=`rgba(${c[0]},${c[1]},${c[2]},0.42)`;ctx.fill();
   ctx.strokeStyle=`rgb(${c[0]},${c[1]},${c[2]})`;ctx.lineWidth=1;ctx.stroke();}}
 if(on('f'))for(const s of D.frusta)seg(s[0],s[1],'#4da3ff',1);
 if(on('t'))polyline(D.traj,'#ff5252',2);
 if(on('o'))polyline(D.opt,'#50fa7b',2);
 if(on('l'))for(const s of D.lc)seg(s[0],s[1],'#f1fa8c',1.5);
 document.getElementById('stat').textContent=
  `${D.traj.length} keyframes | ${D.planes.length} plane hulls | `+
  `${D.traj.length&&LIVE?(frozen?'[k] FROZEN | ':'[k] live | '):''}`+
  `${D.lc.length} LC edges | ${D.pts.length} cloud points`;
}
let drag=0,lx=0,ly=0;
cv.onmousedown=e=>{drag=e.button===2?2:1;lx=e.clientX;ly=e.clientY;};
onmouseup=()=>drag=0;
cv.oncontextmenu=e=>e.preventDefault();
onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-lx,dy=e.clientY-ly;lx=e.clientX;ly=e.clientY;
 if(drag===1){yaw+=dx*0.008;pitch+=dy*0.008;}else{panX+=dx;panY+=dy;}
 draw();};
cv.onwheel=e=>{e.preventDefault();dist*=Math.exp(e.deltaY*0.001);draw();};
onresize=draw;
onkeydown=e=>{
 if(e.key==='k'||e.key==='K'){frozen=!frozen;draw();return;} // freeze (Map360_Visualizer.h:325)
 const k={'t':'tg_t','o':'tg_o','f':'tg_f','p':'tg_p','l':'tg_l','c':'tg_c'}[e.key];
 if(k){const b=document.getElementById(k);b.checked=!b.checked;draw();}};
for(const el of document.querySelectorAll('#hud input'))el.onchange=draw;
// live mode: poll live.json and redraw (the reference visualizer's render
// thread, Map360_Visualizer.h:95-319; 'k' freezes like bFreezeFrame).
// LIVE/frozen are declared BEFORE the initial draw(): draw() reads both for
// the stat line, and a top-level `const` read before initialization throws
// (temporal dead zone), aborting the whole viewer script.
const LIVE=__LIVE__;
let frozen=false, fitted=D.traj.length>0;
draw();
if(LIVE){
 (async function tick(){
  if(!frozen){
   try{
    const r=await fetch('live.json?'+Date.now());
    if(r.ok){D=await r.json();if(!fitted&&D.traj.length){fitView();fitted=true;}draw();}
   }catch(e){}
  }
  setTimeout(tick,__INTERVAL_MS__);
 })();
}
</script></body></html>
"""
