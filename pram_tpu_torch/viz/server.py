"""Interactive 3D map/localization viewer, browser-based, stdlib-only
(pram_tpu/viz/server.py).

The same HTTP surface as the JAX package's viewer, in place of the
reference's pangolin + OpenGL viewer thread (localization/viewer.py:409-560):
a seg-coloured map point cloud, VRF / reference / current / ground-truth
camera frusta, follow-camera, the menu toggles (Tracking / ShowPoints /
ShowSegs / ShowVRFFrame / ShowAllVRFs / ShowRefFrames) and the per-stage
timing readout (viewer.py:423-438,545-560), served to any browser:

- ``GET /``       the viewer page (vanilla-JS 3D canvas, orbit controls)
- ``GET /map``    static map payload: points (subsampled), seg colours,
                  reference-frame and VRF poses
- ``GET /state``  localization stream (poll; ``?since=<seq>`` for deltas)

The localization loop calls :meth:`ViewerServer.update` once a frame (the
equivalent of viewer.py:353 ``Viewer.update``); it is thread-safe and does
not block the producer. The map and the frames are host numpy; the port's
colours come from its own ``utils/visualization.py:generate_color_dic``,
equal to the JAX package's.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from pram_tpu_torch.utils.visualization import generate_color_dic


def _frustum_corners(R: np.ndarray, t: np.ndarray, scale: float = 0.3):
    """Camera frustum corner points in world coordinates (pose = w2c)."""
    w, h, z = 1.0, 0.75, 1.0
    pts_c = np.array(
        [
            [0, 0, 0],
            [-w, -h, z], [w, -h, z], [w, h, z], [-w, h, z],
        ],
        np.float32,
    ) * scale
    # world = R^T (cam - t)
    return (pts_c - t) @ R  # [5, 3]


class _State:
    def __init__(self, max_frames: int = 512):
        self.lock = threading.Lock()
        self.frames: List[Dict] = []
        self.seq = 0
        self.max_frames = max_frames

    def push(self, frame: Dict):
        with self.lock:
            self.seq += 1
            frame = dict(frame, seq=self.seq)
            self.frames.append(frame)
            if len(self.frames) > self.max_frames:
                self.frames = self.frames[-self.max_frames :]

    def since(self, seq: int) -> Dict:
        with self.lock:
            out = [f for f in self.frames if f["seq"] > seq]
            return {"seq": self.seq, "frames": out}


class ViewerServer:
    """Threaded HTTP viewer; one per localization run.

    Args:
      pmap: a PackedMap (maps/packed.py) — point cloud + frames are
        serialized once at startup.
      port: 0 = ephemeral (read ``server.port`` after construction).
      max_points: point-cloud subsample cap for the browser payload.
    """

    def __init__(
        self,
        pmap=None,
        port: int = 0,
        max_points: int = 60000,
        host: str = "127.0.0.1",
    ):
        self._state = _State()
        self._map_payload = self._build_map_payload(pmap, max_points)
        handler = self._make_handler()
        # loopback by default: the stream carries the map point cloud and
        # live poses, so exposing it to the network is an explicit opt-in
        # (host="0.0.0.0")
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    # -- producer API -----------------------------------------------------
    def update(
        self,
        qvec=None,
        tvec=None,
        R=None,
        gt_qvec=None,
        gt_tvec=None,
        gt_R=None,
        success: bool = False,
        tracking: bool = False,
        matched_sid: int = -1,
        num_inliers: int = 0,
        times: Optional[Dict[str, float]] = None,
        name: str = "",
    ):
        """Push one localized frame (viewer.py:353 Viewer.update)."""
        frame: Dict = {
            "success": bool(success),
            "tracking": bool(tracking),
            "matched_sid": int(matched_sid),
            "num_inliers": int(num_inliers),
            "times": {k: float(v) for k, v in (times or {}).items()},
            "name": name,
        }
        if R is not None and tvec is not None:
            Rn = np.asarray(R, np.float32)
            tn = np.asarray(tvec, np.float32)
            frame["frustum"] = _frustum_corners(Rn, tn).tolist()
            frame["center"] = (-(Rn.T @ tn)).tolist()
        if gt_R is not None and gt_tvec is not None:
            gR = np.asarray(gt_R, np.float32)
            gt = np.asarray(gt_tvec, np.float32)
            frame["gt_frustum"] = _frustum_corners(gR, gt).tolist()
        self._state.push(frame)

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- internals --------------------------------------------------------
    @staticmethod
    def _build_map_payload(pmap, max_points: int) -> Dict:
        if pmap is None:
            return {"points": [], "colors": [], "frames": [], "vrfs": []}
        xyz = np.asarray(pmap.point_xyz, np.float32)
        seg = np.asarray(pmap.point_seg, np.int32)
        if xyz.shape[0] > max_points:
            idx = np.linspace(0, xyz.shape[0] - 1, max_points).astype(int)
            xyz, seg = xyz[idx], seg[idx]
        table = generate_color_dic(max(int(seg.max()) + 1, 1))
        color_of = {int(s): list(table[int(s)]) for s in np.unique(seg)}
        frames = []
        for i in range(pmap.frame_R.shape[0]):
            frames.append(
                _frustum_corners(
                    np.asarray(pmap.frame_R[i]), np.asarray(pmap.frame_t[i])
                ).tolist()
            )
        vrfs = [int(v) for v in np.asarray(pmap.vrf_frame_idx)]
        return {
            "points": np.round(xyz, 3).tolist(),
            "segs": seg.tolist(),
            "seg_colors": {str(k): v for k, v in color_of.items()},
            "frames": frames,
            "vrfs": vrfs,
        }

    def _make_handler(server_self):
        state = server_self._state
        map_payload = server_self._map_payload

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, code=200):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    data = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif url.path == "/map":
                    self._json(map_payload)
                elif url.path == "/state":
                    q = parse_qs(url.query)
                    try:
                        since = int(q.get("since", ["0"])[0])
                    except ValueError:
                        since = 0
                    self._json(state.since(since))
                else:
                    self._json({"error": "not found"}, 404)

        return Handler


# ---------------------------------------------------------------------------
# the viewer page: vanilla-JS software-projected 3D canvas with orbit
# controls, mirroring the pangolin menu surface (viewer.py:423-438)
# ---------------------------------------------------------------------------

_PAGE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>pram-tpu map viewer</title>
<style>
 body{margin:0;background:#101014;color:#ddd;font:13px monospace;display:flex}
 #panel{width:185px;padding:10px;background:#1a1a22;height:100vh;box-sizing:border-box}
 #panel label{display:block;margin:4px 0;cursor:pointer}
 #times{margin-top:14px;border-top:1px solid #333;padding-top:8px;white-space:pre}
 canvas{flex:1;height:100vh;display:block}
</style></head><body>
<div id="panel">
 <b>pram-tpu viewer</b>
 <label><input type="checkbox" id="FollowCamera" checked> FollowCamera</label>
 <label><input type="checkbox" id="ShowPoints" checked> ShowPoints</label>
 <label><input type="checkbox" id="ShowSegs" checked> ShowSegs</label>
 <label><input type="checkbox" id="ShowVRFFrame" checked> ShowVRFFrame</label>
 <label><input type="checkbox" id="ShowAllVRFs"> ShowAllVRFs</label>
 <label><input type="checkbox" id="ShowRefFrames"> ShowRefFrames</label>
 <label><input type="checkbox" id="ShowTrail" checked> ShowTrail</label>
 <div id="times">feat : -
rec  : -
loc  : -
ref  : -
total: -</div>
 <div id="status" style="margin-top:8px"></div>
</div>
<canvas id="c"></canvas>
<script>
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let W,H;function resize(){W=cv.width=cv.clientWidth;H=cv.height=cv.clientHeight}
window.addEventListener('resize',resize);
let mapData=null,frames=[],seq=0,trail=[];
let yaw=0.6,pitch=0.4,dist=18,center=[0,0,0],follow=null;
cv.addEventListener('mousedown',e=>{
  const sx=e.clientX,sy=e.clientY,y0=yaw,p0=pitch,btn=e.button,c0=center.slice();
  function mv(e2){const dx=e2.clientX-sx,dy=e2.clientY-sy;
    if(btn===0){yaw=y0+dx*0.008;pitch=Math.max(-1.5,Math.min(1.5,p0+dy*0.008));}
    else{const s=dist*0.002;center=[c0[0]-dx*s*Math.cos(yaw)-0*dy,c0[1]+dy*s,c0[2]+dx*s*Math.sin(yaw)];}
  }
  function up(){removeEventListener('mousemove',mv);removeEventListener('mouseup',up);}
  addEventListener('mousemove',mv);addEventListener('mouseup',up);});
cv.addEventListener('contextmenu',e=>e.preventDefault());
cv.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);});
function chk(id){return document.getElementById(id).checked}
function proj(p){
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  let x=p[0]-center[0],y=p[1]-center[1],z=p[2]-center[2];
  let x1=cy*x-sy*z, z1=sy*x+cy*z;
  let y2=cp*y-sp*z1, z2=sp*y+cp*z1;
  z2+=dist;
  if(z2<0.1)return null;
  const f=0.9*Math.min(W,H);
  return [W/2+f*x1/z2, H/2+f*y2/z2, z2];
}
function line(a,b,col,w){const pa=proj(a),pb=proj(b);if(!pa||!pb)return;
  ctx.strokeStyle=col;ctx.lineWidth=w||1;ctx.beginPath();
  ctx.moveTo(pa[0],pa[1]);ctx.lineTo(pb[0],pb[1]);ctx.stroke();}
function frustum(f,col,w){for(let i=1;i<5;i++){line(f[0],f[i],col,w);
  line(f[i],f[i%4+1],col,w);}}
function draw(){
  ctx.fillStyle='#101014';ctx.fillRect(0,0,W,H);
  if(mapData){
    if(chk('ShowPoints')){
      const pts=mapData.points,segs=mapData.segs,cols=mapData.seg_colors;
      for(let i=0;i<pts.length;i++){
        const p=proj(pts[i]);if(!p)continue;
        if(chk('ShowSegs')){const c=cols[segs[i]]||[180,180,180];
          ctx.fillStyle=`rgb(${c[0]},${c[1]},${c[2]})`;}
        else ctx.fillStyle='#8a8a92';
        const s=Math.max(1,Math.min(3,120/p[2]));
        ctx.fillRect(p[0],p[1],s,s);
      }
    }
    if(chk('ShowRefFrames'))for(const f of mapData.frames)frustum(f,'#3a6ea5',1);
    if(chk('ShowAllVRFs'))for(const vi of mapData.vrfs)frustum(mapData.frames[vi],'#b0b040',1);
  }
  const last=frames[frames.length-1];
  if(last){
    if(chk('ShowVRFFrame')&&last.matched_sid>=0&&mapData&&mapData.vrfs[last.matched_sid]!==undefined)
      frustum(mapData.frames[mapData.vrfs[last.matched_sid]],'#e0e050',2);
    if(last.gt_frustum)frustum(last.gt_frustum,'#50c050',2);
    if(last.frustum)frustum(last.frustum,last.success?'#e05050':'#777',2);
    if(chk('ShowTrail'))for(let i=1;i<trail.length;i++)line(trail[i-1],trail[i],'#e05050',1);
    if(chk('FollowCamera')&&last.center)
      center=last.center.map((v,i)=>0.85*center[i]+0.15*v);
  }
  requestAnimationFrame(draw);
}
async function boot(){
  resize();
  mapData=await (await fetch('/map')).json();
  if(mapData.points.length){
    const m=[0,1,2].map(a=>mapData.points.reduce((s,p)=>s+p[a],0)/mapData.points.length);
    center=m;
  }
  poll();draw();
}
async function poll(){
  try{
    const st=await (await fetch('/state?since='+seq)).json();
    seq=st.seq;
    for(const f of st.frames){frames.push(f);if(f.center)trail.push(f.center);}
    if(trail.length>800)trail=trail.slice(-800);
    const last=frames[frames.length-1];
    if(last){
      const t=last.times||{};
      const ms=k=>t[k]!==undefined?(1000*t[k]).toFixed(1)+' ms':'-';
      document.getElementById('times').textContent=
        `feat : ${ms('feat')}\nrec  : ${ms('rec')}\nloc  : ${ms('loc')}\nref  : ${ms('ref')}\ntotal: ${ms('total')}`;
      document.getElementById('status').textContent=
        `${last.name||''} ${last.success?'OK':'LOST'} `+
        `${last.tracking?'[tracking]':'[reloc]'} inl=${last.num_inliers}`;
    }
  }catch(e){}
  setTimeout(poll,100);
}
boot();
</script></body></html>
"""
