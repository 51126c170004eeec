"""Live interactive viewer — the Pangolin GUI loop equivalent.

Port of orb_slam2_tpu/viz/live.py (host code over numpy and OpenCV).
Three things differ from it:
  - menu actions that change the tracker (Localization Mode, Reset) are
    requests: `System.request_localization_mode` / `request_reset` set
    them, and the tracking thread applies them at the start of its next
    `track_*` call, as the reference's System::Track* does under
    mMutexMode / mMutexReset (src/System.cc:117-186).  The JAX package
    called `reset()` on the viewer's thread, where it can swap the map
    under a frame in flight.  A change of the toggle, not its level,
    makes a request (Viewer.cc:116-125), so the viewer does not undo a
    caller's own `activate_localization_mode()`;
  - the render loop stays alive across an error, as in the JAX package,
    but counts each one (`render_errors`, `last_render_error`), so a
    fault in a drawer does not pass unseen;
  - `LiveViewer` imports cv2 when it is built: without OpenCV the System
    raises at construction instead of carrying on with a dead thread.

The reference runs a Pangolin window on its own thread with a menu
(Follow Camera / Show Points / Show KeyFrames / Show Graph /
Localization Mode / Reset) and renders the map + current frame at the
camera frame rate (ref: src/Viewer.cc:54-170).  Accelerators live in
headless machines, so the interactive surface here is an HTTP control panel:
MJPEG streams of the 3D map view and the tracked-frame overlay plus
menu toggles, served by a background thread — open
http://localhost:<port>/ in any browser.  When a local display exists
(`DISPLAY` set) an optional cv2.imshow window mirrors the streams.

Rendering is a software pinhole projector over the map store's arrays
(one matmul projects every point / frustum vertex) — no OpenGL, no
matplotlib in the hot loop.  The virtual camera follows the current
SLAM camera exactly like Pangolin's `s_cam.Follow(Twc)`
(ref: src/Viewer.cc:87-103, src/MapDrawer.cc:179-222), with the same
viewpoint offset/focal settings (Viewer.ViewpointX/Y/Z/F,
ref: src/Viewer.cc:43-49).

The stop/finish protocol (RequestFinish/isFinished, RequestStop/
Release) mirrors include/Viewer.h via `request_finish`/`is_finished`.
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from typing import Optional

import numpy as np

from orb_slam2_tpu_torch.viz.viewer import FrameDrawer

# virtual window geometry (ref: src/Viewer.cc:64-66 ProjectionMatrix
# (1024, 768, ViewpointF, ViewpointF, 512, 389, 0.1, 1000))
_VW, _VH = 1024, 768
_U0, _V0 = 512.0, 389.0
_ZNEAR = 0.1


def _look_at(eye: np.ndarray, center: np.ndarray,
             up: np.ndarray) -> np.ndarray:
    """CV-convention view matrix (z forward, y down on screen) looking
    from `eye` toward `center` with world `up` appearing screen-up —
    the software stand-in for Pangolin's ModelViewLookAt
    (ref: src/Viewer.cc:69 with AxisNegY ≙ up=(0,-1,0))."""
    z = center - eye
    nz = np.linalg.norm(z)
    z = z / (nz if nz > 1e-9 else 1.0)
    down = -up
    y = down - np.dot(down, z) * z
    ny = np.linalg.norm(y)
    if ny < 1e-9:                       # degenerate: looking along up
        y = np.array([0.0, 0.0, 1.0]) - z * z[2]
        ny = np.linalg.norm(y)
    y = y / ny
    x = np.cross(y, z)
    R = np.stack([x, y, z], 0).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = -R @ eye.astype(np.float32)
    return T


class MapRenderer:
    """Software MapDrawer: points, keyframe frusta, covisibility /
    spanning-tree / loop edges, current camera — drawn into a BGR image
    with one batched projection (ref: src/MapDrawer.cc:44-264)."""

    def __init__(self, system):
        self.system = system
        s = system.settings
        self.vx = getattr(s, "viewpoint_x", 0.0)
        self.vy = getattr(s, "viewpoint_y", -0.7)
        self.vz = getattr(s, "viewpoint_z", -1.8)
        self.vf = getattr(s, "viewpoint_f", 500.0)
        self.kf_size = getattr(s, "keyframe_size", 0.05)
        self.cam_size = getattr(s, "camera_size", 0.08)
        self.point_size = max(1, int(getattr(s, "point_size", 2)))
        self.graph_min_weight = 100   # ref: src/MapDrawer.cc:121
        self._last_view = _look_at(
            np.array([self.vx, self.vy, self.vz]),
            np.zeros(3), np.array([0.0, -1.0, 0.0]))
        # free-orbit camera for non-follow mode (Pangolin's mouse
        # navigation equivalent, ref: src/Viewer.cc:59-66 + :87-103
        # non-follow branch): azimuth/elevation/radius around a pannable
        # target, driven by /view HTTP deltas (mouse drag + wheel)
        r0 = float(np.linalg.norm([self.vx, self.vy, self.vz])) or 5.0
        self.orbit = {"az": 0.0, "el": 0.35, "r": r0}
        self.orbit_target = np.zeros(3, np.float64)
        self._orbit_active = False

    # -- free-orbit camera ----------------------------------------------
    def orbit_update(self, daz=0.0, delv=0.0, dr=1.0, dx=0.0, dy=0.0):
        """Apply a mouse/wheel delta: rotate (daz, delv radians), zoom
        (dr multiplicative), pan (dx, dy in view-plane units of r)."""
        o = self.orbit
        o["az"] = float((o["az"] + daz) % (2 * np.pi))
        o["el"] = float(np.clip(o["el"] + delv, -1.45, 1.45))
        o["r"] = float(np.clip(o["r"] * dr, 0.05, 1e4))
        if dx or dy:
            R = self._orbit_view()[:3, :3]
            self.orbit_target = (self.orbit_target
                                 + R.T @ np.array([dx, dy, 0.0]) * o["r"])
        self._orbit_active = True

    def _orbit_view(self) -> np.ndarray:
        o = self.orbit
        ca, sa = np.cos(o["az"]), np.sin(o["az"])
        ce, se = np.cos(o["el"]), np.sin(o["el"])
        eye = self.orbit_target + o["r"] * np.array([sa * ce, -se, -ca * ce])
        return _look_at(eye, self.orbit_target,
                        np.array([0.0, -1.0, 0.0]))

    # -- projection ----------------------------------------------------
    def _view_matrix(self, follow: bool) -> np.ndarray:
        """Follow mode composes the viewpoint look-at (expressed in the
        current camera's frame) with Tcw, exactly what Pangolin's
        Follow(Twc) does (ref: src/Viewer.cc:87-103).  Non-follow mode
        gives the free-orbit camera once the user has moved it, else the
        last follow view (Pangolin likewise leaves the free camera where
        it was)."""
        tracker = self.system.tracker
        Tcw = None
        fr = tracker.current
        if fr is not None and fr.Tcw is not None:
            Tcw = fr.Tcw
        elif (tracker.last_frame is not None
              and tracker.last_frame.Tcw is not None):
            Tcw = tracker.last_frame.Tcw
        L = _look_at(np.array([self.vx, self.vy, self.vz]),
                     np.zeros(3), np.array([0.0, -1.0, 0.0]))
        if follow and Tcw is not None:
            self._last_view = (L @ Tcw).astype(np.float32)
        elif not follow and self._orbit_active:
            return self._orbit_view().astype(np.float32)
        return self._last_view

    def _project(self, pts: np.ndarray, view: np.ndarray):
        """(N,3) world points -> (N,2)i32 pixels + validity mask."""
        if len(pts) == 0:
            return (np.zeros((0, 2), np.int32),
                    np.zeros(0, bool), np.zeros(0, np.float32))
        pc = pts @ view[:3, :3].T + view[:3, 3]
        z = pc[:, 2]
        ok = z > _ZNEAR
        zs = np.where(ok, z, 1.0)
        u = self.vf * pc[:, 0] / zs + _U0
        v = self.vf * pc[:, 1] / zs + _V0
        ok &= (u >= -2) & (u < _VW + 2) & (v >= -2) & (v < _VH + 2)
        uv = np.stack([u, v], 1)
        return np.round(uv).astype(np.int32), ok, z

    def _frustum_vertices(self, Twc: np.ndarray, size: float):
        """5 wireframe vertices of a camera glyph in world coords
        (ref: src/MapDrawer.cc:179-216 DrawCurrentCamera geometry)."""
        w = size
        h = w * 0.75
        zz = w * 0.6
        local = np.array([
            [0, 0, 0], [w, h, zz], [w, -h, zz], [-w, -h, zz], [-w, h, zz],
        ], np.float32)
        return local @ Twc[:3, :3].T + Twc[:3, 3]

    _FRUSTUM_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4),
                      (1, 2), (2, 3), (3, 4), (4, 1)]

    def _draw_lines(self, img, p0s, p1s, ok, color, thickness=1):
        import cv2

        for (a, b, good) in zip(p0s, p1s, ok):
            if good:
                cv2.line(img, tuple(a), tuple(b), color, thickness,
                         cv2.LINE_AA)

    # -- main entry ----------------------------------------------------
    def render(self, follow: bool = True, show_points: bool = True,
               show_keyframes: bool = True,
               show_graph: bool = True) -> np.ndarray:
        import cv2

        store = self.system.store
        view = self._view_matrix(follow)
        img = np.full((_VH, _VW, 3), 255, np.uint8)

        with store.lock:
            pids = store.valid_pt_ids()
            pt_pos = store.pt_pos[pids].copy() if len(pids) else \
                np.zeros((0, 3), np.float32)
            local = self.system.tracker.local_pts
            local_set = np.zeros(len(pids), bool)
            if len(pids) and len(local):
                local_set = np.isin(pids, local)
            kfs = [int(k) for k in store.valid_kf_ids()]
            kf_Twc = {k: np.linalg.inv(store.kf_pose[k]) for k in kfs}
            covis = {k: dict(store.covis.get(k, {})) for k in kfs}
            parents = {k: int(store.kf_parent[k]) for k in kfs}
            loops = {k: list(store.kf_loop_edges.get(k, ())) for k in kfs}
            fr = self.system.tracker.current
            cur_Tcw = fr.Tcw if fr is not None and fr.Tcw is not None \
                else None

        # map points: black, local-map points red (ref: MapDrawer.cc:44-80)
        if show_points and len(pt_pos):
            uv, ok, _ = self._project(pt_pos, view)
            for sel, color in ((~local_set, (40, 40, 40)),
                               (local_set, (0, 0, 230))):
                m = ok & sel
                if not m.any():
                    continue
                u, v = uv[m, 0], uv[m, 1]
                for du in range(self.point_size):
                    for dv in range(self.point_size):
                        uu = np.clip(u + du, 0, _VW - 1)
                        vv = np.clip(v + dv, 0, _VH - 1)
                        img[vv, uu] = color

        # keyframe frusta: blue (ref: MapDrawer.cc:83-118)
        centers_px = {}
        if kfs:
            verts = np.concatenate(
                [self._frustum_vertices(kf_Twc[k], self.kf_size)
                 for k in kfs], 0)
            uv, ok, _ = self._project(verts, view)
            for i, k in enumerate(kfs):
                p = uv[i * 5:(i + 1) * 5]
                o = ok[i * 5:(i + 1) * 5]
                centers_px[k] = (p[0], o[0])
                if show_keyframes:
                    for (a, b) in self._FRUSTUM_EDGES:
                        if o[a] and o[b]:
                            cv2.line(img, tuple(p[a]), tuple(p[b]),
                                     (200, 80, 0), 1, cv2.LINE_AA)

        # graph: covisibility (w>=100) green, spanning tree, loop edges
        # (ref: src/MapDrawer.cc:120-172)
        if show_graph and kfs:
            drawn = set()
            for k in kfs:
                pk, okk = centers_px.get(k, (None, False))
                if not okk:
                    continue
                for nb, w in covis[k].items():
                    if (w < self.graph_min_weight or (nb, k) in drawn
                            or nb not in centers_px):
                        continue
                    drawn.add((k, nb))
                    pn, okn = centers_px[nb]
                    if okn:
                        cv2.line(img, tuple(pk), tuple(pn),
                                 (90, 200, 90), 1, cv2.LINE_AA)
                par = parents.get(k, -1)
                if par in centers_px:
                    pn, okn = centers_px[par]
                    if okn:
                        cv2.line(img, tuple(pk), tuple(pn),
                                 (90, 200, 90), 1, cv2.LINE_AA)
                for le in loops[k]:
                    if le in centers_px and le > k:
                        pn, okn = centers_px[le]
                        if okn:
                            cv2.line(img, tuple(pk), tuple(pn),
                                     (0, 0, 255), 2, cv2.LINE_AA)

        # current camera: green, larger (ref: MapDrawer.cc:179-216)
        if cur_Tcw is not None:
            Twc = np.linalg.inv(cur_Tcw)
            verts = self._frustum_vertices(Twc, self.cam_size)
            p, o, _ = self._project(verts, view)
            for (a, b) in self._FRUSTUM_EDGES:
                if o[a] and o[b]:
                    cv2.line(img, tuple(p[a]), tuple(p[b]),
                             (0, 180, 0), 2, cv2.LINE_AA)
        return img


_PAGE = """<!doctype html><html><head><title>orb_slam2_tpu_torch viewer</title>
<style>
 body{font-family:sans-serif;background:#1b1b1f;color:#ddd;margin:12px}
 img{border:1px solid #444;max-width:100%}
 .menu button{margin:2px;padding:6px 10px;border:1px solid #555;
   background:#2a2a2e;color:#ddd;cursor:pointer;border-radius:4px}
 .menu button.on{background:#2d6a4f}
 #state{font-size:12px;color:#9a9}
</style></head><body>
<h3>ORB_SLAM2 (PyTorch) — live viewer</h3>
<div class="menu" id="menu"></div>
<p id="state"></p>
<table><tr>
 <td><img id="map" src="/map.mjpg" width="640" draggable="false"
      style="cursor:grab"></td>
 <td><img src="/frame.mjpg" width="640"></td>
</tr></table>
<script>
// free-orbit navigation on the map view (disable Follow Camera first):
// drag = rotate, shift-drag = pan, wheel = zoom
const mapEl=document.getElementById("map");
let drag=null;
mapEl.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];e.preventDefault();};
window.onmouseup=()=>{drag=null;};
window.onmousemove=e=>{
 if(!drag) return;
 const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
 drag=[e.clientX,e.clientY,drag[2]];
 if(drag[2]) fetch(`/view?dx=${-dx*0.002}&dy=${-dy*0.002}`);
 else fetch(`/view?daz=${dx*0.008}&delv=${dy*0.008}`);
};
mapEl.onwheel=e=>{fetch(`/view?dr=${e.deltaY>0?1.12:0.89}`);e.preventDefault();};
</script>
<script>
const MENUS=[["follow_camera","Follow Camera"],["show_points","Show Points"],
 ["show_keyframes","Show KeyFrames"],["show_graph","Show Graph"],
 ["localization_mode","Localization Mode"],["reset","Reset"]];
async function refresh(){
 const st=await (await fetch("/state")).json();
 const m=document.getElementById("menu"); m.innerHTML="";
 for(const [k,label] of MENUS){
  const b=document.createElement("button");
  b.textContent=label; if(st.menu[k]) b.className="on";
  b.onclick=async()=>{await fetch(`/menu?${k}=${st.menu[k]?0:1}`);refresh();};
  m.appendChild(b);
 }
 document.getElementById("state").textContent=JSON.stringify(st.stats);
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


class LiveViewer:
    """Background render loop + HTTP control panel (ref: src/Viewer.cc:
    54-170).  Menu semantics follow the reference: a change of the
    localization toggle asks for System::ActivateLocalizationMode or its
    opposite (Viewer.cc:116-125), Reset asks for a reset of the whole
    system and snaps the menu back (Viewer.cc:139-145); both are applied
    by the tracking thread's next frame.  RequestFinish/RequestStop
    mirror include/Viewer.h.  Raises ImportError without OpenCV."""

    def __init__(self, system, http_port: Optional[int] = 0,
                 show_window: bool = False):
        try:
            import cv2  # noqa: F401  (the render thread draws with it)
        except ImportError as e:
            raise ImportError(
                "the live viewer needs OpenCV: the cv2 module does not "
                "import") from e
        self.system = system
        self.renderer = MapRenderer(system)
        self.frame_drawer = FrameDrawer(system)
        fps = getattr(system.settings, "fps", 30.0) or 30.0
        self.period = 1.0 / max(1.0, float(fps))   # mT (Viewer.cc:59-62)
        self.menu = {
            "follow_camera": True, "show_points": True,
            "show_keyframes": True, "show_graph": True,
            "localization_mode": False, "reset": False,
        }
        self._menu_lock = threading.Lock()
        self._img_lock = threading.Lock()
        self._latest_input: Optional[np.ndarray] = None
        self._map_jpg: Optional[bytes] = None
        self._frame_jpg: Optional[bytes] = None
        self._finish_requested = False
        self._finished = False
        self._stop_requested = False
        self._stopped = False
        # the localization mode last asked of the System: the menu's
        # changes, not its level, become requests (Viewer.cc:116-125)
        self._mode_asked = False
        # renders that raised (the loop carries on) and the last traceback
        self.render_errors = 0
        self.last_render_error: Optional[str] = None
        self.renders = 0
        self.render_s = 0.0
        self.show_window = show_window
        self.port: Optional[int] = None
        self._httpd = None
        if http_port is not None:
            self._start_http(http_port)
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()

    # -- frame feed (FrameDrawer::Update, src/FrameDrawer.cc:167-203) ---
    def push_frame(self, img: np.ndarray):
        with self._img_lock:
            self._latest_input = np.asarray(img)

    # -- menu ------------------------------------------------------------
    def set_menu(self, name: str, value: bool):
        if name not in self.menu:
            raise KeyError(name)
        with self._menu_lock:
            self.menu[name] = bool(value)

    def _apply_menu(self):
        with self._menu_lock:
            menu = dict(self.menu)
        if menu["localization_mode"] != self._mode_asked:
            self.system.request_localization_mode(menu["localization_mode"])
            self._mode_asked = menu["localization_mode"]
        if menu["reset"]:
            # ref: Viewer.cc:139-145 — reset system, restore menu defaults
            self.system.request_reset()
            with self._menu_lock:
                self.menu.update({
                    "follow_camera": True, "localization_mode": False,
                    "reset": False,
                })
            menu["reset"] = False
            self._mode_asked = False    # a reset leaves localization mode
        return menu

    # -- render loop ------------------------------------------------------
    def run(self):
        import cv2

        while not self._finish_requested:
            t0 = time.perf_counter()
            if self._stop_requested:
                self._stopped = True
                time.sleep(0.005)
                continue
            self._stopped = False
            try:
                menu = self._apply_menu()
                map_img = self.renderer.render(
                    follow=menu["follow_camera"],
                    show_points=menu["show_points"],
                    show_keyframes=menu["show_keyframes"],
                    show_graph=menu["show_graph"])
                with self._img_lock:
                    inp = self._latest_input
                frame_img = None
                if inp is not None:
                    with self.system.store.lock:
                        frame_img = self.frame_drawer.draw(inp)
                ok, buf = cv2.imencode(
                    ".jpg", map_img, [cv2.IMWRITE_JPEG_QUALITY, 80])
                if ok:
                    self._map_jpg = buf.tobytes()
                if frame_img is not None:
                    ok, buf = cv2.imencode(
                        ".jpg", frame_img, [cv2.IMWRITE_JPEG_QUALITY, 80])
                    if ok:
                        self._frame_jpg = buf.tobytes()
                if self.show_window:
                    cv2.imshow("ORB-SLAM2: Map", map_img)
                    if frame_img is not None:
                        cv2.imshow("ORB-SLAM2: Current Frame",
                                   frame_img)
                    cv2.waitKey(1)
                self.renders += 1
                self.render_s += time.perf_counter() - t0
            except Exception:   # keep the viewer alive, but count it
                self.render_errors += 1
                self.last_render_error = traceback.format_exc()
            dt = time.perf_counter() - t0
            if dt < self.period:
                time.sleep(self.period - dt)
        self._finished = True

    # -- stop/finish protocol (include/Viewer.h) ---------------------------
    def request_finish(self):
        self._finish_requested = True

    def is_finished(self) -> bool:
        return self._finished

    def request_stop(self):
        self._stop_requested = True

    def is_stopped(self) -> bool:
        return self._stopped

    def release(self):
        self._stop_requested = False

    def close(self):
        self.request_finish()
        self.thread.join(timeout=2.0)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None

    # -- HTTP panel --------------------------------------------------------
    def _start_http(self, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qsl, urlparse

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _mjpeg(self, getter):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                try:
                    while not viewer._finish_requested:
                        jpg = getter()
                        if jpg is not None:
                            self.wfile.write(b"--frame\r\n")
                            self.wfile.write(
                                b"Content-Type: image/jpeg\r\n\r\n")
                            self.wfile.write(jpg)
                            self.wfile.write(b"\r\n")
                        time.sleep(viewer.period)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif url.path == "/map.mjpg":
                    self._mjpeg(lambda: viewer._map_jpg)
                elif url.path == "/frame.mjpg":
                    self._mjpeg(lambda: viewer._frame_jpg)
                elif url.path == "/map.jpg":
                    self._send(200, "image/jpeg", viewer._map_jpg or b"")
                elif url.path == "/frame.jpg":
                    self._send(200, "image/jpeg", viewer._frame_jpg or b"")
                elif url.path == "/state":
                    with viewer._menu_lock:
                        menu = dict(viewer.menu)
                    body = json.dumps({
                        "menu": menu,
                        "stats": viewer.system.stats(),
                        "state": viewer.system.tracking_state().name,
                    }).encode()
                    self._send(200, "application/json", body)
                elif url.path == "/menu":
                    for k, v in parse_qsl(url.query):
                        try:
                            viewer.set_menu(k, v not in ("0", "false", ""))
                        except KeyError:
                            self._send(404, "text/plain", b"unknown menu")
                            return
                    self._send(200, "application/json", b"{}")
                elif url.path == "/view":
                    # free-orbit camera deltas (non-follow mode):
                    # daz/delv radians, dr multiplicative zoom, dx/dy pan
                    kw = {}
                    for k, v in parse_qsl(url.query):
                        if k in ("daz", "delv", "dr", "dx", "dy"):
                            try:
                                kw[k] = float(v)
                            except ValueError:
                                pass
                    viewer.renderer.orbit_update(**kw)
                    self._send(200, "application/json", b"{}")
                else:
                    self._send(404, "text/plain", b"not found")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
