"""Input blocks of the fused tracking step, assembled in numpy as the JAX
package's Tracker assembles them, and the tests of that assembly.

The track-step tests (tests/test_torch_track_step*.py) and chip_smoke.py
import this module to drive the steps of both packages on the same
inputs.  It imports neither jax nor torch, so it also loads on a machine
without jax.  It mirrors the Tracker's code and adds no feature:

- `stereo_init_map` is Tracker._stereo_initialization
  (orb_slam2_tpu/slam/tracking.py:1168-1198) with the normal and the
  scale-invariance distance band of MapStore.update_points_batch
  (orb_slam2_tpu/slam/map_store.py:520-554): the first frame is the world
  origin and every valid feature with depth > 0 becomes a point.
- `TrackState.blocks` is Tracker._fast_prep (slam/tracking.py:367-429):
  the last block holds the previous frame's bound inliers, the local
  block every map point, `excl` the points already in the last block,
  T_pred = velocity @ last Tcw, and fwd / bwd from the baseline test.
- `TrackState.apply` is what Tracker._fast_finish and _track keep for the
  next frame (slam/tracking.py:462-474, 580): bindings from the step's
  slots, outliers, the pose and the constant-velocity model.
"""

import numpy as np

N_SCAL = 20


def stereo_init_map(xy, depth, valid, octave, desc, fx, fy, cx, cy,
                    scale_factors) -> dict:
    """Map points of the first stereo frame: position (frame = world),
    unit normal from the camera centre, [min_dist, max_dist] band, the
    feature's descriptor, and `feat`, the feature each point came from."""
    feat = np.nonzero((depth > 0) & valid)[0]
    z = depth[feat].astype(np.float32)
    u, v = xy[feat, 0], xy[feat, 1]
    pos = np.stack([(u - cx) * z / fx, (v - cy) * z / fy, z],
                   -1).astype(np.float32)
    dist = np.linalg.norm(pos, axis=1)
    sf = np.asarray(scale_factors)
    max_dist = dist * sf[octave[feat]]
    return dict(
        pos=pos,
        normal=(pos / np.maximum(dist, 1e-9)[:, None]).astype(np.float32),
        max_dist=max_dist.astype(np.float32),
        min_dist=(max_dist / sf[-1]).astype(np.float32),
        desc=np.asarray(desc)[feat].astype(np.uint32),
        feat=feat,
    )


class TrackState:
    """The Tracker's state between two fused steps: the last frame's
    bindings, outliers, pose and feature fields, and the velocity."""

    def __init__(self, points: dict, octave, angle, m_bucket: int,
                 baseline: float, mode: str = "stereo"):
        n = len(octave)
        self.points = points
        self.pt_valid = np.ones(len(points["pos"]), bool)
        self.bindings = np.full(n, -1, np.int64)
        self.bindings[points["feat"]] = np.arange(len(points["pos"]))
        self.outlier = np.zeros(n, bool)
        self.Tcw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)  # identity on frame 1
        self.octave = np.asarray(octave, np.int32)
        self.angle = np.asarray(angle, np.float32)
        self.m_bucket = m_bucket
        self.baseline = baseline
        self.mode = mode

    def blocks(self):
        """(blocks, cand, last_pids): the step's numpy inputs but the
        images (keys of convert.TRACK_INPUTS), the local candidates'
        point ids and the last block's point ids."""
        pts = self.points
        T_pred = (self.velocity @ self.Tcw).astype(np.float32)

        bind = self.bindings
        pids = np.where(bind >= 0, bind, 0)
        has = (bind >= 0) & self.pt_valid[pids] & ~self.outlier
        last_f32 = np.concatenate(
            [pts["pos"][pids], has[:, None].astype(np.float32)], 1)

        cand = np.nonzero(self.pt_valid)[0]
        nc, M = len(cand), self.m_bucket
        if nc > M:
            raise ValueError(f"{nc} local points do not fit a block of {M}")
        loc_f32 = np.zeros((M, 8), np.float32)
        loc_f32[:nc, :3] = pts["pos"][cand]
        loc_f32[:nc, 3:6] = pts["normal"][cand]
        loc_f32[:nc, 6] = pts["min_dist"][cand]
        loc_f32[:nc, 7] = pts["max_dist"][cand]
        loc_desc = np.zeros((M, 8), np.uint32)
        loc_desc[:nc] = pts["desc"][cand]
        excl = np.zeros(M, np.uint8)
        excl[:nc] = (~self.pt_valid[cand]
                     | np.isin(cand, pids[has])).astype(np.uint8)

        tlc = self.Tcw @ np.linalg.inv(T_pred)
        mono = self.mode == "mono"
        scal = np.zeros(N_SCAL, np.float32)
        scal[:16] = T_pred.reshape(-1)
        scal[16] = (not mono) and tlc[2, 3] > self.baseline
        scal[17] = (not mono) and -tlc[2, 3] > self.baseline
        scal[18] = 3.0 if self.mode == "rgbd" else 1.0
        scal[19] = nc
        blocks = dict(
            scal=scal, last_f32=last_f32.astype(np.float32),
            last_desc=pts["desc"][pids], last_oct=self.octave,
            last_angle=self.angle, loc_f32=loc_f32, loc_desc=loc_desc,
            loc_excl=excl,
        )
        return blocks, cand, pids

    def apply(self, res: dict, cand, last_pids) -> np.ndarray:
        """Take a step's result (TrackResult fields as a dict) as the new
        last frame; returns its bindings (point id per feature, -1)."""
        a = res["assign"]
        L = len(last_pids)
        bindings = np.full(len(a), -1, np.int64)
        from_last = (a >= 0) & (a < L)
        bindings[from_last] = last_pids[a[from_last]]
        from_local = a >= L
        loc_slots = a[from_local] - L
        in_range = loc_slots < len(cand)
        bindings[np.nonzero(from_local)[0][in_range]] = cand[
            loc_slots[in_range]]
        Tcw = np.asarray(res["Tcw"], np.float32)
        self.velocity = (Tcw @ np.linalg.inv(self.Tcw)).astype(np.float32)
        self.Tcw = Tcw
        self.bindings = bindings
        self.outlier = (bindings >= 0) & ~res["inlier"]
        self.octave = np.asarray(res["octave"], np.int32)
        self.angle = np.asarray(res["angle"], np.float32)
        return bindings


def pose_error(T_est, T_true):
    """(camera-centre distance, rotation angle in degrees) between two
    world-to-camera poses.  The angle is atan2(sin, cos) with the sine
    from the skew part of the relative rotation (its norm is 2 sin) and
    the cosine from its trace: the arccos of the trace alone loses every
    angle below about 0.03 deg to the rounding of 1 - cos."""
    def centre(T):
        return -T[:3, :3].T @ T[:3, 3]

    dR = np.asarray(T_est[:3, :3], np.float64) @ np.asarray(
        T_true[:3, :3], np.float64).T
    skew = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                     dR[1, 0] - dR[0, 1]])
    angle = np.arctan2(0.5 * np.linalg.norm(skew), (np.trace(dR) - 1.0) / 2.0)
    return (float(np.linalg.norm(centre(T_est) - centre(T_true))),
            float(np.degrees(angle)))


# ---------------------------------------------------------------------------
# tests of the assembly, on a hand-made frame
# ---------------------------------------------------------------------------

FX, CX, CY = 100.0, 50.0, 40.0
SF = 1.2 ** np.arange(4)


def _frame():
    """Six features: 0-3 valid with depth, 4 valid without, 5 invalid."""
    xy = np.array([[50, 40], [60, 40], [50, 50], [30, 20], [10, 10],
                   [5, 5]], np.float32)
    depth = np.array([2.0, 4.0, 1.0, 3.0, -1.0, 2.0], np.float32)
    valid = np.array([1, 1, 1, 1, 1, 0], bool)
    octave = np.array([0, 1, 3, 2, 0, 0], np.int32)
    desc = np.arange(48, dtype=np.uint32).reshape(6, 8)
    return xy, depth, valid, octave, desc


def test_stereo_init_map_unprojects_valid_depths():
    xy, depth, valid, octave, desc = _frame()
    pts = stereo_init_map(xy, depth, valid, octave, desc, FX, FX, CX, CY, SF)
    np.testing.assert_array_equal(pts["feat"], [0, 1, 2, 3])
    np.testing.assert_allclose(pts["pos"][0], [0, 0, 2])
    np.testing.assert_allclose(pts["pos"][1], [0.4, 0, 4], rtol=1e-6)
    np.testing.assert_allclose(pts["pos"][3], [-0.6, -0.6, 3], rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(pts["normal"], axis=1), 1,
                               rtol=1e-6)
    dist = np.linalg.norm(pts["pos"], axis=1)
    np.testing.assert_allclose(pts["max_dist"], dist * SF[[0, 1, 3, 2]],
                               rtol=1e-6)
    np.testing.assert_allclose(pts["min_dist"], pts["max_dist"] / SF[-1],
                               rtol=1e-6)
    np.testing.assert_array_equal(pts["desc"], desc[:4])


def test_blocks_shapes_has_and_excl():
    xy, depth, valid, octave, desc = _frame()
    pts = stereo_init_map(xy, depth, valid, octave, desc, FX, FX, CX, CY, SF)
    st = TrackState(pts, octave, np.zeros(6), m_bucket=8, baseline=0.5)
    st.outlier[1] = True                 # a bound outlier leaves `has`
    blocks, cand, pids = st.blocks()
    assert blocks["scal"].shape == (N_SCAL,)
    assert blocks["last_f32"].shape == (6, 4)
    assert blocks["last_desc"].shape == (6, 8)
    assert blocks["last_desc"].dtype == np.uint32
    assert blocks["loc_f32"].shape == (8, 8)
    assert blocks["loc_desc"].shape == (8, 8)
    assert blocks["loc_excl"].shape == (8,) and blocks["loc_excl"].dtype \
        == np.uint8
    np.testing.assert_array_equal(blocks["last_f32"][:, 3],
                                  [1, 0, 1, 1, 0, 0])
    np.testing.assert_array_equal(cand, [0, 1, 2, 3])
    # points bound (and inliers) in the last frame are matched through
    # the last block, so the local block excludes them; point 1 is an
    # outlier there and stays a local candidate
    np.testing.assert_array_equal(blocks["loc_excl"],
                                  [1, 0, 1, 1, 0, 0, 0, 0])
    assert blocks["scal"][19] == 4
    np.testing.assert_array_equal(blocks["scal"][:16],
                                  np.eye(4, dtype=np.float32).reshape(-1))
    assert blocks["scal"][16] == 0 and blocks["scal"][17] == 0
    assert blocks["scal"][18] == 1.0


def test_forward_motion_sets_fwd_and_apply_maps_slots():
    xy, depth, valid, octave, desc = _frame()
    pts = stereo_init_map(xy, depth, valid, octave, desc, FX, FX, CX, CY, SF)
    st = TrackState(pts, octave, np.zeros(6), m_bucket=8, baseline=0.5)
    st.velocity[2, 3] = -0.8             # the camera moves 0.8 m forward
    blocks, cand, pids = st.blocks()
    assert blocks["scal"][16] == 1 and blocks["scal"][17] == 0
    # feature 0 <- last slot 2 (point 2), feature 4 <- local slot 3
    # (point 3), feature 5 <- a padding slot beyond the candidates
    L = len(pids)
    res = dict(assign=np.array([2, -1, -1, -1, L + 3, L + 6], np.int32),
               inlier=np.array([1, 0, 0, 0, 0, 1], bool),
               Tcw=np.eye(4), octave=octave, angle=np.ones(6))
    bindings = st.apply(res, cand, pids)
    np.testing.assert_array_equal(bindings, [2, -1, -1, -1, 3, -1])
    np.testing.assert_array_equal(st.outlier, [0, 0, 0, 0, 1, 0])
    np.testing.assert_allclose(st.velocity, np.eye(4), atol=1e-7)
    blocks, _, _ = st.blocks()
    np.testing.assert_array_equal(blocks["last_f32"][:, 3],
                                  [1, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(blocks["last_angle"], np.ones(6))


def test_pose_error_of_a_known_offset():
    T = np.eye(4)
    T2 = np.eye(4)
    c, s = np.cos(np.radians(2.0)), np.sin(np.radians(2.0))
    T2[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T2[:3, 3] = [0.3, 0.0, 0.4]
    dt, dr = pose_error(T2, T)
    assert abs(dr - 2.0) < 1e-9 and abs(dt - 0.5) < 1e-9


def _rot(axis, deg):
    """Rodrigues rotation about a unit `axis` by `deg` degrees."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    th = np.radians(deg)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def test_pose_error_reads_small_rotations():
    """1e-4, 1e-3 and 1e-2 deg are read to 1e-6 relative from float64
    poses and within 1e-5 deg from float32 poses (the arccos of the trace
    read 0.000 for all three); a large angle and the half turn still come
    out right."""
    import pytest

    base = np.eye(4)
    base[:3, :3] = _rot([0.3, -0.5, 0.8], 37.0)
    base[:3, 3] = [0.4, -1.0, 2.5]
    for deg in (1e-4, 1e-3, 1e-2):
        T = np.eye(4)
        T[:3, :3] = _rot([0.2, 0.9, -0.4], deg) @ base[:3, :3]
        T[:3, 3] = base[:3, 3]
        _, dr = pose_error(T, base)
        assert dr == pytest.approx(deg, rel=1e-6)
        # float32 poses, as the steps return them: 6e-8 of rounding in
        # each entry is 3.4e-6 deg
        _, dr32 = pose_error(T.astype(np.float32), base.astype(np.float32))
        assert abs(dr32 - deg) <= 1e-5, (deg, dr32)
    for deg in (2.0, 120.0, 180.0):
        T = np.eye(4)
        T[:3, :3] = _rot([0.0, 1.0, 0.0], deg)
        assert pose_error(T, np.eye(4))[1] == pytest.approx(deg, abs=1e-6)
