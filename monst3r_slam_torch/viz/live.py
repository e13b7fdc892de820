"""Live reconstruction viewer: in-process HTTP server + browser renderer.

The port's copy of the JAX package's `viz/live.py` (stdlib and numpy, no
device code): the same snapshot and frame bytes. The reference system runs a
moderngl/imgui window in a separate process (`visualization.py:42-474`);
here the live surface is a localhost web viewer: the SLAM loop posts state
snapshots (downsampled cloud, keyframe poses, trajectory) to a daemon-thread
HTTP server, and a dependency-free canvas page polls `/state.bin` and
re-renders. The entry points start it unless `--no-viz` is given.

Binary snapshot layout (little-endian):
  uint32 seq, n_points, n_traj, n_kf, n_seg, has_surfel, gh, gw
  f32 points[n_points*3], u8 colors[n_points*3], zero padding to 4 bytes,
  f32 traj[n_traj*3], f32 kf[n_kf*3], f32 segs[n_seg*6],
  and with has_surfel f32 normals[n_points*3], f32 radii[n_points]
(kf = keyframe center markers; segs = frustum line segments; gh, gw the
per-keyframe grid of the mesh mode, 0 without one)

Control channel (the reference's `WindowMsg` feedback path,
`visualization.py:33-39,355-361`): the page POSTs JSON to `/control`
(pause/unpause, single-step, C_conf display threshold, relocalization
request, terminate); the SLAM loop consumes it between frames via
`poll_control()`. `/frame.bin` streams the latest input frame with the
dynamic mask composited (the reference's dynamic-mask overlay,
`visualization.py:118-126,334-344`).
"""

from __future__ import annotations

import http.server
import socketserver
import struct
import threading
from typing import Optional

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>monst3r-slam live</title>
<style>body{margin:0;background:#111;color:#9a9;font:12px monospace}
#hud{position:fixed;top:6px;left:8px}
#ctrl{position:fixed;bottom:8px;left:8px}
#ctrl button{background:#233;color:#9a9;border:1px solid #465;margin-right:4px;
font:12px monospace;cursor:pointer}
#fr{position:fixed;top:6px;right:8px;border:1px solid #465}</style></head>
<body><canvas id="c"></canvas><div id="hud">connecting...</div>
<canvas id="fr" width="0" height="0"></canvas>
<div id="ctrl">
<button id="bpause">pause</button><button id="bstep">step</button>
<button id="breloc">reloc</button><button id="bterm">terminate</button>
<button id="bmesh">mesh</button>
C_conf <input id="cconf" type="range" min="0" max="10" step="0.1" value="1.5">
<span id="cval">1.5</span></div>
<script>
const canvas = document.getElementById('c');
const hud = document.getElementById('hud');
canvas.width = innerWidth; canvas.height = innerHeight;
const ctx = canvas.getContext('2d');
let pts = new Float32Array(0), cols = new Uint8Array(0);
let traj = new Float32Array(0), kfs = new Float32Array(0);
let segs = new Float32Array(0);
let nrms = new Float32Array(0), rads = new Float32Array(0);
let gh = 0, gw = 0, meshMode = false;
let seq = -1, center = [0,0,0], scale = 1;
let yaw = 0.5, pitch = 0.4, dist = 4;
let dragging = false, lx = 0, ly = 0;
canvas.onmousedown = e => { dragging = true; lx = e.x; ly = e.y; };
window.onmouseup = () => dragging = false;
window.onmousemove = e => {
  if (!dragging) return;
  yaw += (e.x - lx) * 0.005; pitch += (e.y - ly) * 0.005;
  lx = e.x; ly = e.y; draw();
};
canvas.onwheel = e => { dist *= Math.exp(e.deltaY * 0.001); draw(); e.preventDefault(); };
function recenter() {
  if (!pts.length) return;
  let c = [0,0,0], n = 0;
  for (let i = 0; i < pts.length; i += 3) {
    if (!isFinite(pts[i])) continue;
    c[0]+=pts[i]; c[1]+=pts[i+1]; c[2]+=pts[i+2]; n++;
  }
  if (!n) return;
  center = [c[0]/n, c[1]/n, c[2]/n];
  let d = [];
  for (let i = 0; i < pts.length; i += 3*7) {
    if (!isFinite(pts[i])) continue;
    const dx=pts[i]-center[0], dy=pts[i+1]-center[1], dz=pts[i+2]-center[2];
    d.push(Math.sqrt(dx*dx+dy*dy+dz*dz));
  }
  d.sort((a,b)=>a-b);
  scale = d[Math.floor(d.length*0.9)] || 1;
}
function fillTri(img, zbuf, W, H, p0, p1, p2, r, g, b) {
  // z-buffered flat-shaded triangle (trianglemap.glsl raster equivalent)
  const minx = Math.max(0, Math.floor(Math.min(p0[0], p1[0], p2[0])));
  const maxx = Math.min(W - 1, Math.ceil(Math.max(p0[0], p1[0], p2[0])));
  const miny = Math.max(0, Math.floor(Math.min(p0[1], p1[1], p2[1])));
  const maxy = Math.min(H - 1, Math.ceil(Math.max(p0[1], p1[1], p2[1])));
  if (maxx - minx > 96 || maxy - miny > 96) return;  // degenerate sliver
  const z = (p0[2] + p1[2] + p2[2]) / 3;
  const e = (a, b2, x, y) => (b2[0]-a[0])*(y-a[1]) - (b2[1]-a[1])*(x-a[0]);
  const area = e(p0, p1, p2[0], p2[1]);
  if (area === 0) return;
  const s = area > 0 ? 1 : -1;
  for (let y = miny; y <= maxy; y++) {
    for (let x = minx; x <= maxx; x++) {
      if (s*e(p0, p1, x, y) < 0 || s*e(p1, p2, x, y) < 0 ||
          s*e(p2, p0, x, y) < 0) continue;
      const idx = y * W + x;
      if (z > zbuf[idx]) continue;
      zbuf[idx] = z;
      const o = idx * 4;
      img.data[o] = r; img.data[o+1] = g; img.data[o+2] = b;
      img.data[o+3] = 255;
    }
  }
}
function proj(x, y, z, cyaw, syaw, cp, sp, f) {
  x -= center[0]; y -= center[1]; z -= center[2];
  x /= scale; y /= scale; z /= scale;
  const x1 = cyaw * x + syaw * z, z1 = -syaw * x + cyaw * z;
  const y1 = cp * y - sp * z1, z2 = sp * y + cp * z1 + dist;
  if (z2 < 0.05) return null;
  return [canvas.width/2 + f*x1/z2, canvas.height/2 + f*y1/z2, z2];
}
function draw() {
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, canvas.width, canvas.height);
  const cyaw = Math.cos(yaw), syaw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const f = 0.8 * Math.min(canvas.width, canvas.height);
  const img = ctx.createImageData(canvas.width, canvas.height);
  const zbuf = new Float32Array(canvas.width * canvas.height).fill(1e9);
  const W = canvas.width, H = canvas.height;
  const surfel = nrms.length === pts.length && rads.length * 3 === pts.length;
  if (meshMode && gw > 1 && gh > 1) {
    // Triangle-mesh mode (reference trianglemap.glsl:1-144): two CCW
    // triangles per grid cell whose 4 vertices are valid (non-NaN = above
    // the conf gate), slant-gated on the view-rotated normal, flat-shaded.
    const npkf = gh * gw, nkf = Math.floor(pts.length / 3 / npkf);
    const P = new Array(4);
    for (let k = 0; k < nkf; k++) {
      const base = k * npkf;
      for (let y = 0; y + 1 < gh; y++) {
        for (let x = 0; x + 1 < gw; x++) {
          const i00 = base + y*gw + x, i01 = i00 + 1;
          const i10 = i00 + gw, i11 = i10 + 1;
          let ok = true;
          const vix = [i00, i01, i10, i11];
          for (let q = 0; q < 4 && ok; q++) {
            const j = vix[q] * 3;
            if (!isFinite(pts[j])) { ok = false; break; }
            P[q] = proj(pts[j], pts[j+1], pts[j+2], cyaw, syaw, cp, sp, f);
            if (!P[q]) ok = false;
          }
          if (!ok) continue;
          let shade = 1.0;
          if (surfel) {
            const j = i00 * 3;
            const nz1 = -syaw*nrms[j] + cyaw*nrms[j+2];
            const nz2 = sp*nrms[j+1] + cp*nz1;
            if (Math.abs(nz2) < 0.1) continue;   // slant_threshold
            shade = 0.35 + 0.65 * Math.abs(nz2);
          }
          let r = 0, g = 0, b = 0;
          for (let q = 0; q < 4; q++) {
            const j = vix[q] * 3;
            r += cols[j]; g += cols[j+1]; b += cols[j+2];
          }
          r = r/4*shade; g = g/4*shade; b = b/4*shade;
          fillTri(img, zbuf, W, H, P[0], P[2], P[1], r, g, b);
          fillTri(img, zbuf, W, H, P[1], P[2], P[3], r, g, b);
        }
      }
    }
  } else
  for (let i = 0; i < pts.length; i += 3) {
    if (!isFinite(pts[i])) continue;
    const p = proj(pts[i], pts[i+1], pts[i+2], cyaw, syaw, cp, sp, f);
    if (!p) continue;
    const u = Math.round(p[0]), v = Math.round(p[1]);
    let shade = 1.0, half = 0;
    if (surfel) {
      // normal-shaded splat (the reference's surfelmap.glsl path):
      // rotate the world normal into view, Lambert vs the view direction
      const nx = nrms[i], ny = nrms[i+1], nz = nrms[i+2];
      const nz1 = -syaw * nx + cyaw * nz;
      const nz2 = sp * ny + cp * nz1;
      shade = 0.35 + 0.65 * Math.abs(nz2);
      // screen-space radius from the world surfel footprint
      const rpx = f * (rads[i/3] / scale) / p[2];
      half = Math.min(7, Math.max(0, Math.round(rpx * 0.5)));
    }
    const r = cols[i] * shade, g = cols[i+1] * shade, b = cols[i+2] * shade;
    for (let dv = -half; dv <= half; dv++) {
      const vv = v + dv;
      if (vv < 0 || vv >= H) continue;
      for (let du = -half; du <= half; du++) {
        const uu = u + du;
        if (uu < 0 || uu >= W) continue;
        const idx = vv * W + uu;
        if (p[2] > zbuf[idx]) continue;
        zbuf[idx] = p[2];
        const o = idx * 4;
        img.data[o] = r; img.data[o+1] = g;
        img.data[o+2] = b; img.data[o+3] = 255;
      }
    }
  }
  ctx.putImageData(img, 0, 0);
  ctx.strokeStyle = '#4f4'; ctx.lineWidth = 1.5; ctx.beginPath();
  let started = false;
  for (let i = 0; i < traj.length; i += 3) {
    const p = proj(traj[i], traj[i+1], traj[i+2], cyaw, syaw, cp, sp, f);
    if (!p) { started = false; continue; }
    if (started) ctx.lineTo(p[0], p[1]); else ctx.moveTo(p[0], p[1]);
    started = true;
  }
  ctx.stroke();
  ctx.fillStyle = '#ff4';
  for (let i = 0; i < kfs.length; i += 3) {
    const p = proj(kfs[i], kfs[i+1], kfs[i+2], cyaw, syaw, cp, sp, f);
    if (p) ctx.fillRect(p[0]-2, p[1]-2, 4, 4);
  }
  ctx.strokeStyle = '#fa4'; ctx.lineWidth = 1; ctx.beginPath();
  for (let i = 0; i < segs.length; i += 6) {
    const p0 = proj(segs[i], segs[i+1], segs[i+2], cyaw, syaw, cp, sp, f);
    const p1 = proj(segs[i+3], segs[i+4], segs[i+5], cyaw, syaw, cp, sp, f);
    if (p0 && p1) { ctx.moveTo(p0[0], p0[1]); ctx.lineTo(p1[0], p1[1]); }
  }
  ctx.stroke();
}
async function poll() {
  try {
    const r = await fetch('/state.bin', {cache: 'no-store'});
    const buf = await r.arrayBuffer();
    const head = new Uint32Array(buf, 0, 8);
    if (head[0] !== seq) {
      seq = head[0];
      const np_ = head[1], nt = head[2], nk = head[3], ns = head[4];
      const hasSurfel = head[5];
      gh = head[6]; gw = head[7];
      let off = 32;
      pts = new Float32Array(buf.slice(off, off + np_*12)); off += np_*12;
      cols = new Uint8Array(buf.slice(off, off + np_*3)); off += np_*3;
      off += (4 - off % 4) % 4;
      traj = new Float32Array(buf.slice(off, off + nt*12)); off += nt*12;
      kfs = new Float32Array(buf.slice(off, off + nk*12)); off += nk*12;
      segs = new Float32Array(buf.slice(off, off + ns*24)); off += ns*24;
      if (hasSurfel) {
        nrms = new Float32Array(buf.slice(off, off + np_*12)); off += np_*12;
        rads = new Float32Array(buf.slice(off, off + np_*4));
      } else { nrms = new Float32Array(0); rads = new Float32Array(0); }
      recenter(); draw();
      hud.textContent = `update ${seq}: ${np_} ` +
        (meshMode && gw > 1 ? 'mesh verts' : hasSurfel ? 'surfels' : 'pts') +
        `, ${nk} keyframes, ${nt} poses`;
    }
  } catch (e) { hud.textContent = 'stream lost: ' + e; }
  try {
    const r = await fetch('/frame.bin', {cache: 'no-store'});
    const buf = await r.arrayBuffer();
    if (buf.byteLength >= 8) {
      const wh = new Uint32Array(buf, 0, 2);
      const fr = document.getElementById('fr');
      if (fr.width !== wh[0]) { fr.width = wh[0]; fr.height = wh[1]; }
      const rgb = new Uint8Array(buf, 8);
      const id = new ImageData(wh[0], wh[1]);
      for (let i = 0, j = 0; i < rgb.length; i += 3, j += 4) {
        id.data[j] = rgb[i]; id.data[j+1] = rgb[i+1];
        id.data[j+2] = rgb[i+2]; id.data[j+3] = 255;
      }
      fr.getContext('2d').putImageData(id, 0, 0);
    }
  } catch (e) {}
  setTimeout(poll, 1000);
}
let paused = false;
function post(obj) { fetch('/control', {method: 'POST', body: JSON.stringify(obj)}); }
document.getElementById('bpause').onclick = e => {
  paused = !paused; e.target.textContent = paused ? 'resume' : 'pause';
  post({pause: paused});
};
document.getElementById('bstep').onclick = () => post({step: true});
document.getElementById('bmesh').onclick = e => {
  meshMode = !meshMode;
  e.target.textContent = meshMode ? 'splats' : 'mesh';
  draw();
};
document.getElementById('breloc').onclick = () => post({reloc: true});
document.getElementById('bterm').onclick = () => post({terminate: true});
document.getElementById('cconf').oninput = e => {
  document.getElementById('cval').textContent = e.target.value;
  post({C_conf: parseFloat(e.target.value)});
};
poll();
</script></body></html>
"""

_EMPTY = struct.pack("<8I", 0, 0, 0, 0, 0, 0, 0, 0)


class LiveViewer:
    """Thread-safe snapshot store + daemon HTTP server."""

    def __init__(self):
        self._lock = threading.Lock()
        self._blob = _EMPTY
        self._frame_blob = b""
        self._seq = 0
        self._server: Optional[socketserver.TCPServer] = None
        self.port: Optional[int] = None
        # Control state (WindowMsg parity, visualization.py:33-39):
        # `pause` and `C_conf` are persistent; `step`/`reloc`/`terminate`
        # are one-shots consumed by poll_control().
        self._ctrl = {"pause": False, "C_conf": None}
        self._ctrl_once = {"step": False, "reloc": False, "terminate": False}

    # -- control channel ---------------------------------------------------

    def push_control(self, msg: dict):
        """Merge a control message (from /control or tests)."""
        with self._lock:
            for k in ("pause",):
                if k in msg:
                    self._ctrl[k] = bool(msg[k])
            if "C_conf" in msg:
                try:
                    self._ctrl["C_conf"] = float(msg["C_conf"])
                except (TypeError, ValueError):
                    pass
            for k in self._ctrl_once:
                if msg.get(k):
                    self._ctrl_once[k] = True

    def poll_control(self) -> dict:
        """Current control state; one-shot flags are cleared on read."""
        with self._lock:
            out = dict(self._ctrl)
            out.update(self._ctrl_once)
            for k in self._ctrl_once:
                self._ctrl_once[k] = False
        return out

    # -- frame overlay stream ---------------------------------------------

    def update_frame(
        self,
        img_u8: np.ndarray,  # (h, w, 3) uint8
        dyn_mask: Optional[np.ndarray] = None,  # (h, w) bool
        max_w: int = 320,
    ):
        """Publish the current input frame with the dynamic mask tinted red
        (the reference's dynamic-mask overlay, visualization.py:118-126)."""
        img = np.asarray(img_u8, np.uint8)
        if img.ndim != 3 or img.shape[-1] != 3:
            return
        if dyn_mask is not None and dyn_mask.shape == img.shape[:2]:
            img = img.copy()
            m = np.asarray(dyn_mask, bool)
            img[m] = (0.45 * img[m] + np.asarray([140.0, 0.0, 0.0])).astype(
                np.uint8
            )
        stride = max(1, -(-img.shape[1] // max_w))  # ceil: 512/320 -> 2
        img = np.ascontiguousarray(img[::stride, ::stride])
        blob = struct.pack("<2I", img.shape[1], img.shape[0]) + img.tobytes()
        with self._lock:
            self._frame_blob = blob

    @staticmethod
    def frustum_segments(kf_poses: np.ndarray, size: float = 0.1) -> np.ndarray:
        """Sim(3) keyframe poses (k, 8: t, q_xyzw, s) -> (k*8, 2, 3) line
        segments forming camera frustums (apex->corners + image-plane ring),
        the live-viewer equivalent of the reference's Frustums geometry
        (`visualization_utils.py:27-83`)."""
        kf_poses = np.asarray(kf_poses, np.float32).reshape(-1, 8)
        t = kf_poses[:, :3]
        q = kf_poses[:, 3:7]  # xyzw
        s = kf_poses[:, 7:8]
        x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        R = np.stack(
            [
                1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
            ],
            axis=-1,
        ).reshape(-1, 3, 3)
        a, b, f = 0.8 * size, 0.6 * size, size
        local = np.array(
            [
                [0, 0, 0],
                [-a, -b, f], [a, -b, f], [a, b, f], [-a, b, f],
            ],
            np.float32,
        )  # apex + 4 corners
        pts = (
            np.einsum("kij,cj->kci", R, local) * s[:, :, None] + t[:, None, :]
        )  # (k, 5, 3)
        idx = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
        segs = np.stack(
            [np.stack([pts[:, i], pts[:, j]], axis=1) for i, j in idx], axis=1
        )  # (k, 8, 2, 3)
        return segs.reshape(-1, 2, 3)

    def update(
        self,
        points: np.ndarray,  # (n, 3) float
        colors: np.ndarray,  # (n, 3) float [0,1] or uint8
        traj: Optional[np.ndarray] = None,  # (t, 3) camera centers
        kf_centers: Optional[np.ndarray] = None,  # (k, 3)
        kf_segments: Optional[np.ndarray] = None,  # (L, 2, 3) frustum lines
        normals: Optional[np.ndarray] = None,  # (n, 3) world normals
        radii: Optional[np.ndarray] = None,  # (n,) surfel radii (world units)
        grid: Optional[tuple] = None,  # (gh, gw): points are per-keyframe
        # row-major grids of gh*gw vertices (NaN = hole) — enables the mesh
        # render mode (trianglemap.glsl parity)
        max_points: int = 250_000,
    ):
        """With `normals` + `radii`, the page renders normal-shaded surfel
        splats (the reference's surfelmap.glsl path); otherwise z-buffered
        points. With `grid`, a mesh toggle renders filled triangles between
        valid grid neighbors (the reference's trianglemap.glsl path)."""
        points = np.asarray(points, np.float32).reshape(-1, 3)
        colors = np.asarray(colors).reshape(-1, 3)
        if colors.dtype != np.uint8:
            colors = np.uint8(np.clip(colors, 0, 1) * 255)
        has_surfel = normals is not None and radii is not None
        if has_surfel:
            normals = np.asarray(normals, np.float32).reshape(-1, 3)
            radii = np.asarray(radii, np.float32).reshape(-1)
        gh, gw = (0, 0) if grid is None else (int(grid[0]), int(grid[1]))
        if grid is None:
            # non-grid callers: NaNs carry no structure, drop them + budget
            finite = np.isfinite(points).all(axis=1)
            points, colors = points[finite], colors[finite]
            if has_surfel:
                normals, radii = normals[finite], radii[finite]
            if points.shape[0] > max_points:
                sel = np.random.default_rng(0).choice(
                    points.shape[0], max_points, replace=False
                )
                points, colors = points[sel], colors[sel]
                if has_surfel:
                    normals, radii = normals[sel], radii[sel]
        traj = (
            np.zeros((0, 3), np.float32)
            if traj is None
            else np.asarray(traj, np.float32).reshape(-1, 3)
        )
        kf = (
            np.zeros((0, 3), np.float32)
            if kf_centers is None
            else np.asarray(kf_centers, np.float32).reshape(-1, 3)
        )
        segs = (
            np.zeros((0, 2, 3), np.float32)
            if kf_segments is None
            else np.asarray(kf_segments, np.float32).reshape(-1, 2, 3)
        )
        self._seq += 1
        head = struct.pack(
            "<8I", self._seq, points.shape[0], traj.shape[0], kf.shape[0],
            segs.shape[0], int(has_surfel), gh, gw,
        )
        body = points.tobytes() + colors.tobytes()
        body += b"\0" * ((4 - (len(head) + len(body)) % 4) % 4)
        blob = head + body + traj.tobytes() + kf.tobytes() + segs.tobytes()
        if has_surfel:
            blob += normals.tobytes() + radii.tobytes()
        with self._lock:
            self._blob = blob

    def start(self, port: int = 8089) -> Optional[int]:
        """Serve on localhost:port (tries a few successors if busy; port 0
        takes a free one from the system).

        Returns the bound port, or None if no port could be bound."""
        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path in ("/state.bin", "/frame.bin"):
                    with viewer._lock:
                        blob = (
                            viewer._blob
                            if self.path == "/state.bin"
                            else viewer._frame_blob
                        )
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(blob)))
                    self.end_headers()
                    self.wfile.write(blob)
                else:
                    page = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(page)))
                    self.end_headers()
                    self.wfile.write(page)

            def do_POST(self):
                if self.path == "/control":
                    import json

                    n = int(self.headers.get("Content-Length", 0) or 0)
                    try:
                        msg = json.loads(self.rfile.read(n) or b"{}")
                        viewer.push_control(msg)
                        code = 200
                    except (ValueError, TypeError):
                        code = 400
                    self.send_response(code)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

            def log_message(self, *a):  # quiet
                pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        for p in range(port, port + 16):
            try:
                self._server = Server(("127.0.0.1", p), Handler)
            except OSError:
                continue
            self.port = self._server.server_address[1]
            t = threading.Thread(target=self._server.serve_forever, daemon=True)
            t.start()
            return self.port
        return None

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
