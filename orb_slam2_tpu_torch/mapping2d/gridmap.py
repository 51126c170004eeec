"""2D occupancy-grid mapping — the abhineet123 fork's headline feature.

Copy of orb_slam2_tpu/mapping2d/gridmap.py (host-side numpy, no framework).

Host-side equivalent of the fork's grid-map stack:
  - Monosub's live grid builder (ref: Examples/ROS/ORB_SLAM2/src/
    ros_mono_sub.cc:219-425): per-keyframe point projection onto the
    x-z plane, per-cell occupied counters, integer Bresenham visited-ray
    counting from the keyframe cell, optional local-counter saturation,
    getGridMap's thresholded free/unknown/occupied map, and a full
    rebuild on loop closure (:342-399).
  - System::SaveGridMapTUM's direct PGM export (ref: src/System.cc:
    481-629, fixed 450x300 grid with Bresenham ray casting).
  - the offline pointCloudToGridMap2D.py pipeline (lattice-space
    Bresenham from a timestamped point export).

All Bresenham loops are vectorized across rays: each numpy step replays
one `for (x = x0; x <= x1; ++x)` iteration of EVERY ray simultaneously
with the same integer/double semantics as the reference's scalar loops,
so counters match the reference cell-for-cell.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class GridParams:
    """Monosub's tunables (ref: ros_mono_sub.cc:25-38, steps:76-78)."""

    scale_factor: float = 10.0       # cells per meter
    cloud_min_x: float = -20.0
    cloud_max_x: float = 20.0
    cloud_min_z: float = -20.0
    cloud_max_z: float = 20.0
    free_thresh: float = 0.55
    occupied_thresh: float = 0.50
    visit_thresh: int = 0
    use_local_counters: bool = False

    # scaled-grid quantities, exactly as Monosub computes them
    # (ref: ros_mono_sub.cc:83-118: grid_min = cloud_min*scale,
    #  h/w = int(grid_res), norm = float(res-1)/float(res))
    @property
    def grid_min(self) -> Tuple[float, float]:          # (x, z)
        return (self.cloud_min_x * self.scale_factor,
                self.cloud_min_z * self.scale_factor)

    @property
    def shape(self) -> Tuple[int, int]:                 # (h, w)
        h = int((self.cloud_max_z - self.cloud_min_z) * self.scale_factor)
        w = int((self.cloud_max_x - self.cloud_min_x) * self.scale_factor)
        return h, w

    @property
    def norm_factor(self) -> Tuple[float, float]:       # (x, z)
        res_x = (self.cloud_max_x - self.cloud_min_x) * self.scale_factor
        res_z = (self.cloud_max_z - self.cloud_min_z) * self.scale_factor
        return (np.float32(res_x - 1) / np.float32(res_x),
                np.float32(res_z - 1) / np.float32(res_z))


def _bresenham_visit(visited: np.ndarray, start_xz, pt_cells: np.ndarray):
    """Exact vectorized port of Monosub's per-ray integer Bresenham
    (ref: processMapPt ros_mono_sub.cc:242-274): increments `visited`
    along each (keyframe-cell -> point-cell) ray INCLUDING both
    endpoints, with the reference's exact steep/endpoint swaps and the
    double `error += dy/dx; if (error >= 0.5)` stepping."""
    if len(pt_cells) == 0:
        return
    h, w = visited.shape
    n = len(pt_cells)
    x0 = np.full(n, int(start_xz[0]), np.int64)
    y0 = np.full(n, int(start_xz[1]), np.int64)
    x1 = pt_cells[:, 0].astype(np.int64)
    y1 = pt_cells[:, 1].astype(np.int64)
    steep = np.abs(y1 - y0) > np.abs(x1 - x0)
    x0s = np.where(steep, y0, x0)
    y0s = np.where(steep, x0, y0)
    x1s = np.where(steep, y1, x1)
    y1s = np.where(steep, x1, y1)
    swap = x0s > x1s
    x0f = np.where(swap, x1s, x0s)
    x1f = np.where(swap, x0s, x1s)
    y0f = np.where(swap, y1s, y0s)
    y1f = np.where(swap, y0s, y1s)
    dx = x1f - x0f
    dy = np.abs(y1f - y0f)
    with np.errstate(divide="ignore", invalid="ignore"):
        # dx == 0 implies dy == 0 (post-steep-swap dy <= dx): 0/0 = NaN,
        # and NaN >= 0.5 is False — the single step never increments y,
        # matching the C loop's one iteration with error = NaN
        deltaerr = dy.astype(np.float64) / dx.astype(np.float64)
    ystep = np.where(y0f < y1f, 1, -1).astype(np.int64)
    err = np.zeros(n, np.float64)
    y = y0f.copy()
    for i in range(int(dx.max()) + 1):
        act = i <= dx
        x = x0f + i
        row = np.where(steep, x, y)     # visited.at<int>(x, y) if steep
        col = np.where(steep, y, x)     # else visited.at<int>(y, x)
        sel = act & (row >= 0) & (row < h) & (col >= 0) & (col < w)
        np.add.at(visited, (row[sel], col[sel]), 1)
        err = err + deltaerr
        dec = err >= 0.5
        y = y + ystep * np.where(act & dec, 1, 0)
        err = err - np.where(dec, 1.0, 0.0)


class GridMapper:
    """Live occupancy grid fed by the keyframe/point stream — a
    quirk-exact Monosub equivalent (ref: ros_mono_sub.cc), including
    the floor((p*scale - grid_min) * norm_factor) cell mapping and
    getGridMap's C integer division `1 - occupieds / visits`."""

    def __init__(self, store, params: Optional[GridParams] = None):
        self.store = store
        self.p = params or GridParams()
        h, w = self.p.shape
        self.visited = np.zeros((h, w), np.int64)
        self.occupied = np.zeros((h, w), np.int64)
        self._processed: List[int] = []

    # ------------------------------------------------------------------
    def _to_cell(self, x: np.ndarray, z: np.ndarray) -> np.ndarray:
        """World (x, z) -> grid cell, exactly as Monosub computes it
        (ref: :241-243, :325-327): scale, subtract scaled grid min,
        multiply by the float norm factor, floor."""
        gmx, gmz = self.p.grid_min
        nfx, nfz = self.p.norm_factor
        cx = np.floor((x * self.p.scale_factor - gmx) * nfx)
        cz = np.floor((z * self.p.scale_factor - gmz) * nfz)
        return np.stack([cx, cz], -1).astype(np.int64)

    def _kf_points(self, kf: int) -> np.ndarray:
        row = self.store.kf_obs[kf]
        pids = row[row >= 0]
        pids = pids[self.store.pt_valid[pids]]
        return self.store.pt_pos[pids]

    def update_keyframe(self, kf: int):
        """Incremental update from one keyframe (ref: updateGridMap
        ros_mono_sub.cc:308-340)."""
        store = self.store
        if not store.kf_valid[kf]:
            return
        C = store.camera_center(kf)
        h, w = self.visited.shape
        start = self._to_cell(np.float64(C[0]), np.float64(C[2]))
        # keyframe cell out of bounds: skip the whole update (ref: :328-332)
        if not (0 <= start[0] < w and 0 <= start[1] < h):
            return
        pts = self._kf_points(kf)
        if len(pts) == 0:
            return
        cells = self._to_cell(pts[:, 0].astype(np.float64),
                              pts[:, 2].astype(np.float64))
        inb = ((cells[:, 0] >= 0) & (cells[:, 0] < w)
               & (cells[:, 1] >= 0) & (cells[:, 1] < h))
        cells = cells[inb]
        if self.p.use_local_counters:
            # local counters saturate per-update (ref: processMapPts
            # :276-300): where the point mask is set occupied := visited,
            # elsewhere occupied := 0, then both fold into the globals
            local_v = np.zeros_like(self.visited)
            local_o = np.zeros_like(self.occupied)
            _bresenham_visit(local_v, start, cells)
            np.add.at(local_o, (cells[:, 1], cells[:, 0]), 1)
            pt_mask = local_o > 0
            local_o = np.where(pt_mask, local_v, 0)
            self.visited += local_v
            self.occupied += local_o
        else:
            _bresenham_visit(self.visited, start, cells)
            np.add.at(self.occupied, (cells[:, 1], cells[:, 0]), 1)
        self._processed.append(kf)

    def rebuild(self):
        """Full rebuild from every valid keyframe — invoked on loop
        closure (ref: resetGridMap ros_mono_sub.cc:342-399)."""
        self.visited[:] = 0
        self.occupied[:] = 0
        self._processed.clear()
        for kf in self.store.valid_kf_ids():
            self.update_keyframe(int(kf))

    # ------------------------------------------------------------------
    def _grid_map(self) -> np.ndarray:
        """getGridMap's float map (ref: ros_mono_sub.cc:402-425).  The
        reference computes `1.0 - float(occupieds / visits)` — a C
        INTEGER division — so any visited cell is exactly free (1.0)
        until occupied counts reach visits, then occupied (<= 0.0).
        Reproduced verbatim; it is what Monosub actually publishes."""
        intdiv = self.occupied // np.maximum(self.visited, 1)
        return np.where(self.visited > self.p.visit_thresh,
                        1.0 - intdiv.astype(np.float32), 0.5)

    def occupancy(self) -> np.ndarray:
        """Free/unknown/occupied grid as u8 {255, 128, 0}
        (ref: getGridMap ros_mono_sub.cc:402-425)."""
        g = self._grid_map()
        out = np.zeros(g.shape, np.uint8)
        out[g >= self.p.free_thresh] = 255
        out[(g < self.p.free_thresh) & (g >= self.p.occupied_thresh)] = 128
        return out

    def ros_occupancy_data(self) -> np.ndarray:
        """nav_msgs/OccupancyGrid-style data: (1 - grid) * 100 cast to
        char (ref: :421-423)."""
        return ((1.0 - self._grid_map()) * 100).astype(np.int8)

    def save_pgm(self, path: str):
        save_pgm(self.occupancy(), path)


# ---------------------------------------------------------------------------
def save_pgm(grid: np.ndarray, path: str):
    """ASCII P2 PGM like the reference's savers (ref: src/System.cc:615)."""
    h, w = grid.shape
    with open(path, "w") as f:
        f.write(f"P2\n{w} {h}\n255\n")
        for row in grid:
            f.write(" ".join(str(int(v)) for v in row) + "\n")


def save_grid_map_pgm(store, path: str,
                      params: Optional[GridParams] = None):
    """One-shot export from the in-memory map (ref: System::SaveGridMapTUM
    src/System.cc:481-629, which ray-casts the full map into a fixed
    grid and writes PGM)."""
    m = GridMapper(store, params)
    m.rebuild()
    m.save_pgm(path)


def save_grid_map_tum(store, path: str):
    """Exact behavioral port of the fork's System::SaveGridMapTUM
    (ref: src/System.cc:481-629): fixed 450x300 grid over the camera
    x-y plane, upper-left corner (-1.5, -2.5), 10 mm cells, one
    occupied count per in-range map point, integer-error Bresenham
    visit rays from every observing keyframe, and the same ASCII P2
    grey mapping (unvisited=230, grey = occup/visit*255 boosted by
    +100 when nonzero, written as 255-grey).

    Two reference quirks are reproduced so outputs stay comparable
    cell-for-cell:

    - the endpoint-exchange branch (System.cc `if (x0 > x1)`) assigns
      the *_grid_y / *_grid_x values unconditionally, which for
      non-steep rays mixes the x and y grid coordinates;
    - the resulting out-of-range second index in `grid_visit[x][y]`
      aliases into subsequent rows of the contiguous [450][300]
      buffer, which we emulate by flat indexing (writes that would
      land beyond the whole buffer — C UB — are dropped).

    The Bresenham error loop is vectorized across all rays: each
    numpy step replays one `for (x = x0; x <= x1; x++)` iteration of
    every ray simultaneously with identical integer/double semantics.
    """
    ul_x, ul_y = -1.5, -2.5
    res = 10
    w_, h_ = 450, 300

    occup = np.zeros(w_ * h_, np.float64)   # flat [x][y] like the C arrays
    visit = np.zeros(w_ * h_, np.float64)

    def cells_of(px, py):
        # C: ((int)((p - ul) * 1000)) / 10 — both steps truncate toward 0
        gx = np.trunc(np.trunc((px - ul_x) * 1000.0) / res).astype(np.int64)
        gy = np.trunc(np.trunc((py - ul_y) * 1000.0) / res).astype(np.int64)
        return gx, gy

    pts = store.valid_pt_ids()
    if len(pts) == 0:
        grid = np.full((h_, w_), 230, np.int64)
        _write_p2(grid, path)
        return

    pos = store.pt_pos[pts].astype(np.float32)
    mp_gx, mp_gy = cells_of(pos[:, 0].astype(np.float64),
                            pos[:, 1].astype(np.float64))
    inb = (mp_gx >= 0) & (mp_gx < w_) & (mp_gy >= 0) & (mp_gy < h_)

    rays = []  # (okf_gx, okf_gy, mp_gx, mp_gy)
    kf_cell_cache: dict = {}
    for pid, gx, gy, ok in zip(pts, mp_gx, mp_gy, inb):
        if not ok:
            continue
        occup[int(gx) * h_ + int(gy)] += 1.0
        for kf, _feat in store.obs.items(int(pid)):
            if not store.kf_valid[kf]:
                continue
            c = kf_cell_cache.get(kf)
            if c is None:
                cc = store.camera_center(kf)
                kx, ky = cells_of(np.float64(cc[0]), np.float64(cc[1]))
                c = (int(kx), int(ky),
                     0 <= kx < w_ and 0 <= ky < h_)
                kf_cell_cache[kf] = c
            if c[2]:
                rays.append((c[0], c[1], int(gx), int(gy)))

    if rays:
        r = np.asarray(rays, np.int64)
        okx, oky, mpx, mpy = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
        steep = np.abs(mpy - oky) > np.abs(mpx - okx)
        x0 = np.where(steep, oky, okx)
        y0 = np.where(steep, okx, oky)
        x1 = np.where(steep, mpy, mpx)
        y1 = np.where(steep, mpx, mpy)
        swap = x0 > x1
        # reference quirk: the exchange uses *_grid_y / *_grid_x
        # regardless of `steep` (System.cc:576-583)
        x0 = np.where(swap, mpy, x0)
        x1 = np.where(swap, oky, x1)
        y0 = np.where(swap, mpx, y0)
        y1 = np.where(swap, okx, y1)
        deltax = x1 - x0
        deltay = np.abs(y1 - y0)
        with np.errstate(divide="ignore", invalid="ignore"):
            deltaerr = deltay.astype(np.float64) / deltax.astype(np.float64)
        ystep = np.where(y0 < y1, 1, -1).astype(np.int64)
        err = np.zeros(len(r), np.float64)
        y = y0.copy()
        n_steps = int(max(deltax.max(), 0))
        for i in range(n_steps + 1):
            act = i <= deltax                       # x = x0+i <= x1
            x = x0 + i
            fidx = np.where(steep, y * h_ + x, x * h_ + y)
            sel = act & (fidx >= 0) & (fidx < w_ * h_)
            np.add.at(visit, fidx[sel], 1.0)
            err = err + deltaerr
            dec = err >= 0.5                        # NaN compares False
            y = y + ystep * np.where(act & dec, 1, 0)
            err = err - np.where(dec, 1.0, 0.0)

    occ2 = occup.reshape(w_, h_)
    vis2 = visit.reshape(w_, h_)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = occ2 / vis2
    grey = np.trunc(np.where(vis2 == 0, 0.0, ratio) * 255).astype(np.int64)
    grey = np.where(grey > 0, grey + 100, grey)
    grey = np.minimum(grey, 255)
    out = np.where(vis2 == 0, 230, 255 - grey)      # [x][y]
    _write_p2(out.T, path)                          # rows over y, cols x


def _write_p2(grid: np.ndarray, path: str):
    """Reference's exact P2 writer: value + trailing space per cell,
    newline per row (ref: src/System.cc:605-625)."""
    h, w = grid.shape
    with open(path, "w") as f:
        f.write(f"P2\n{w} {h}\n255\n")
        for row in grid:
            f.write("".join(f"{int(v)} " for v in row) + "\n")


def _bresenham_lattice(starts: np.ndarray, ends: np.ndarray,
                       visit_cb, occupied_cb):
    """Vectorized port of the offline script's get_line_bresenham +
    counter loop (ref: pointCloudToGridMap2D.py:7-54, 225-262): integer
    error `int(dx/2); error -= |dy|; if error < 0: y += ystep` stepping
    over the scaled-coordinate lattice.  Every ray point EXCEPT the map
    point endpoint goes to visit_cb; the endpoint goes to occupied_cb
    (the script reverses the list when swapped so points[-1] is always
    the map point)."""
    n = len(starts)
    if n == 0:
        return
    x0 = starts[:, 0].astype(np.int64)
    y0 = starts[:, 1].astype(np.int64)
    x1 = ends[:, 0].astype(np.int64)
    y1 = ends[:, 1].astype(np.int64)
    steep = np.abs(y1 - y0) > np.abs(x1 - x0)
    x0s = np.where(steep, y0, x0)
    y0s = np.where(steep, x0, y0)
    x1s = np.where(steep, y1, x1)
    y1s = np.where(steep, x1, y1)
    swapped = x0s > x1s
    x0f = np.where(swapped, x1s, x0s)
    x1f = np.where(swapped, x0s, x1s)
    y0f = np.where(swapped, y1s, y0s)
    y1f = np.where(swapped, y0s, y1s)
    dx = x1f - x0f
    dy = y1f - y0f
    err = dx // 2                                # int(dx / 2.0)
    ystep = np.where(y0f < y1f, 1, -1).astype(np.int64)
    y = y0f.copy()
    # the map-point endpoint sits at iteration dx when not swapped,
    # at iteration 0 when swapped (list reversal)
    end_i = np.where(swapped, 0, dx)
    for i in range(int(dx.max()) + 1):
        act = i <= dx
        x = x0f + i
        px = np.where(steep, y, x)
        py = np.where(steep, x, y)
        is_end = i == end_i
        sel_v = act & ~is_end
        visit_cb(px[sel_v], py[sel_v])
        sel_e = act & is_end
        occupied_cb(px[sel_e], py[sel_e])
        err = err - np.abs(dy)
        dec = err < 0
        y = y + ystep * np.where(act & dec, 1, 0)
        err = err + np.where(dec, dx, 0)


def grid_from_timestamped_points(points_path: str,
                                 params: Optional[GridParams] = None,
                                 kf_trajectory_path: Optional[str] = None,
                                 filter_ground_points: bool = False
                                 ) -> np.ndarray:
    """Port of the fork's offline pointCloudToGridMap2D.py (ref: :90-300)
    from Map::SaveWithTimestamps output: each point line is `x y z ts...`
    where ts are the observing keyframes' timestamps; keyframe positions
    come from the TUM keyframe trajectory.  Rays run from each observing
    keyframe to the point over the scale_factor lattice with the
    script's own Bresenham (all ray points but the last are visits, the
    last is an occupied count — or a visit for filtered ground points),
    cells normalized by floor((v - grid_min) * norm_factor).

    With params=None the grid bounds auto-fit the data (floor/ceil of
    scaled coords, ref: :180-196), like the script.  The returned map
    reproduces the script's thresholding incl. its Python-2 integer
    division (`1 - occ/visit` over int32 arrays) and its occ==0 ->
    unknown quirk (ref: :283-297).
    """
    p = params
    sf = (p.scale_factor if p else 3.0)

    kf_pos: Dict[float, np.ndarray] = {}
    kf_quat: Dict[float, np.ndarray] = {}
    if kf_trajectory_path:
        for line in open(kf_trajectory_path):
            v = line.split()
            if len(v) >= 4:
                ts = round(float(v[0]), 4)
                kf_pos[ts] = np.array(
                    [float(v[1]), float(v[2]), float(v[3])]) * sf
                if len(v) >= 8:
                    kf_quat[ts] = np.array([float(x) for x in v[4:8]])

    pt_xyz: List[np.ndarray] = []
    pt_obs_ts: List[List[float]] = []
    for line in open(points_path):
        v = line.split()
        if len(v) < 3:
            continue
        pt_xyz.append(np.array([float(v[0]), float(v[1]),
                                float(v[2])]) * sf)
        pt_obs_ts.append([round(float(t), 4) for t in v[3:]])
    if not pt_xyz:
        return np.full((1, 1), 128, np.uint8)
    pts = np.stack(pt_xyz)

    is_ground = np.zeros(len(pts), bool)
    if filter_ground_points and kf_quat:
        # ref: :137-170 — transform into the first observing keyframe's
        # frame; negative height marks a ground point
        for i, ts_list in enumerate(pt_obs_ts):
            for ts in ts_list:
                if ts in kf_quat and ts in kf_pos:
                    q = kf_quat[ts] / np.linalg.norm(kf_quat[ts])
                    qx, qy, qz, qw = q        # TUM order
                    R = _quat_to_mat(qw, qx, qy, qz)
                    local = R.T @ (pts[i] - kf_pos[ts])
                    is_ground[i] = bool(local[1] < 0)
                    break

    if p is None:
        kf_arr = (np.stack(list(kf_pos.values()))
                  if kf_pos else pts)
        gmin_x = min(np.floor(kf_arr[:, 0].min()), np.floor(pts[:, 0].min()))
        gmin_z = min(np.floor(kf_arr[:, 2].min()), np.floor(pts[:, 2].min()))
        gmax_x = max(np.ceil(kf_arr[:, 0].max()), np.ceil(pts[:, 0].max()))
        gmax_z = max(np.ceil(kf_arr[:, 2].max()), np.ceil(pts[:, 2].max()))
    else:
        gmin_x, gmax_x = p.cloud_min_x * sf, p.cloud_max_x * sf
        gmin_z, gmax_z = p.cloud_min_z * sf, p.cloud_max_z * sf
    res_x = int(gmax_x - gmin_x)
    res_z = int(gmax_z - gmin_z)
    if res_x <= 1 or res_z <= 1:
        return np.full((max(res_z, 1), max(res_x, 1)), 128, np.uint8)
    nfx = float(res_x - 1) / float(gmax_x - gmin_x)
    nfz = float(res_z - 1) / float(gmax_z - gmin_z)

    # counters indexed [x][z] like the script's numpy arrays
    visit = np.zeros((res_x, res_z), np.int64)
    occupied = np.zeros((res_x, res_z), np.int64)

    starts, ends, ray_ground = [], [], []
    for i, ts_list in enumerate(pt_obs_ts):
        e = (int(pts[i, 0]), int(pts[i, 2]))     # int() truncation, ref :229
        for ts in ts_list:
            pos = kf_pos.get(ts)
            if pos is None:
                continue
            starts.append((int(pos[0]), int(pos[2])))
            ends.append(e)
            ray_ground.append(is_ground[i])
    if starts:
        starts = np.asarray(starts, np.int64)
        ends = np.asarray(ends, np.int64)
        ray_ground = np.asarray(ray_ground, bool)

        def norm_cells(px, pz):
            cx = np.floor((px - gmin_x) * nfx).astype(np.int64)
            cz = np.floor((pz - gmin_z) * nfz).astype(np.int64)
            ok = (cx >= 0) & (cx < res_x) & (cz >= 0) & (cz < res_z)
            return cx, cz, ok

        def visit_cb(px, pz):
            cx, cz, ok = norm_cells(px, pz)
            np.add.at(visit, (cx[ok], cz[ok]), 1)

        # split ground vs non-ground so endpoint routing stays
        # vectorized (ground-point endpoints count as visits, ref :254-262)
        for mask, end_to_occ in ((~ray_ground, True), (ray_ground, False)):
            if not mask.any():
                continue

            def end_cb(px, pz, to_occ=end_to_occ):
                cx, cz, ok = norm_cells(px, pz)
                tgt = occupied if to_occ else visit
                np.add.at(tgt, (cx[ok], cz[ok]), 1)

            _bresenham_lattice(starts[mask], ends[mask], visit_cb, end_cb)

    # script thresholds with Python-2 integer division (ref: :283-297)
    intdiv = occupied // np.maximum(visit, 1)
    unknown = (visit == 0) | (occupied == 0)
    g = np.where(unknown, 0.5, 1.0 - intdiv.astype(np.float32))
    out = np.zeros(g.shape, np.uint8)
    out[g >= (p.free_thresh if p else 0.55)] = 255
    occ_th = (p.occupied_thresh if p else 0.50)
    free_th = (p.free_thresh if p else 0.55)
    out[(g >= occ_th) & (g < free_th)] = 128
    # script array layout is [x][z]; return rows over z like GridMapper
    return out.T


def _quat_to_mat(w, x, y, z):
    """Unit quaternion -> rotation matrix (transforms3d.quat2mat)."""
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
