"""The relocalization matcher and the two Sim3 matchers of loop closing
(ops/matching.py: search_reloc_points, search_by_sim3_projection,
search_by_sim3_mutual) of the port against the JAX package on the CPU.
Scenes are made by numpy from a seed: features scattered over an image,
map points that project onto some of them with descriptors a few bit
flips away, decoys, masked rows and padded tails.  idx (where ok), ok and
dist must be EQUAL: the searches are integer work behind float gates, and
the scenes keep every gate's operands away from its threshold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.ops import matching as jmatching
from orb_slam2_tpu_torch.ops import matching

W, H = 640, 480
FX = FY = 500.0
CX, CY = 320.0, 240.0
CAM = (FX, FY, CX, CY)
N_LEVELS = 8
SF = (1.2 ** np.arange(N_LEVELS)).astype(np.float32)
LOG_SF = float(np.log(1.2))
BOUNDS = np.array([0.0, W, 0.0, H], np.float32)


def T(a):
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def j(a):
    return jnp.asarray(a)


def flip_bits(desc, n_flip, rng):
    out = desc.copy()
    for row in out:
        for b in rng.choice(256, n_flip, replace=False):
            row[b // 32] ^= np.uint32(1 << (b % 32))
    return out


def pose(rng, rot=0.05, trans=0.2):
    from scipy.spatial.transform import Rotation
    Tm = np.eye(4, dtype=np.float32)
    Tm[:3, :3] = Rotation.from_rotvec(rng.normal(0, rot, 3)).as_matrix()
    Tm[:3, 3] = rng.normal(0, trans, 3)
    return Tm


def scene(seed, n_feat=400, n_pts=256, n_live=200, sim3_scale=1.0):
    """A frame's features and a block of map points seen from Tcw (with
    an optional Sim3 scale): point k < n_live/2 sits on feature k with a
    close descriptor, the rest are decoys; rows past n_live are padding.
    """
    rng = np.random.default_rng(seed)
    Tcw = pose(rng)
    xy = np.stack([rng.uniform(20, W - 20, n_feat),
                   rng.uniform(20, H - 20, n_feat)], -1).astype(np.float32)
    octave = rng.integers(0, 4, n_feat).astype(np.int32)
    desc = rng.integers(0, 2 ** 32, (n_feat, 8), dtype=np.uint64).astype(
        np.uint32)
    angle = rng.uniform(0, 360, n_feat).astype(np.float32)
    free = rng.random(n_feat) > 0.1
    n_on = n_live // 2
    # points on features: unproject at a depth, off the pixel by < 1.5 px
    z = rng.uniform(3, 9, n_pts).astype(np.float32)
    uv = np.stack([rng.uniform(20, W - 20, n_pts),
                   rng.uniform(20, H - 20, n_pts)], -1).astype(np.float32)
    uv[:n_on] = xy[:n_on] + rng.uniform(-1.5, 1.5, (n_on, 2))
    pc = np.stack([(uv[:, 0] - CX) * z / FX, (uv[:, 1] - CY) * z / FY, z],
                  -1)
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    pts_w = ((pc - t) / sim3_scale @ R).astype(np.float32)
    pt_desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint64).astype(
        np.uint32)
    pt_desc[:n_on] = flip_bits(desc[:n_on], 12, rng)
    # the distance band puts the predicted level at the feature's octave
    dist = np.linalg.norm(pc / sim3_scale, axis=1).astype(np.float32)
    lvl = np.zeros(n_pts, np.int32)
    lvl[:n_on] = octave[:n_on]
    max_d = (dist * SF[lvl] * 0.95).astype(np.float32)
    min_d = (max_d / SF[-1] * 0.5).astype(np.float32)
    mask = np.arange(n_pts) < n_live
    mask[rng.integers(0, n_on, 5)] = False
    kf_angle = rng.uniform(0, 360, n_pts).astype(np.float32)
    kf_angle[:n_on] = (angle[:n_on] + 20.0) % 360.0
    pts_w[n_live:] = 0.0
    return dict(Tcw=Tcw, xy=xy, octave=octave, desc=desc, angle=angle,
                free=free, pts_w=pts_w, pt_desc=pt_desc, min_d=min_d,
                max_d=max_d, mask=mask, kf_angle=kf_angle, n_on=n_on)


def assert_matches_equal(got, want, min_ok):
    ok = got.ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(want.ok))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    np.testing.assert_array_equal(got.idx.numpy()[ok],
                                  np.asarray(want.idx)[ok])
    assert ok.sum() >= min_ok, ok.sum()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("th,orb_dist,check_rotation", [
    (10.0, 100, True), (3.0, 64, True), (10.0, 100, False)])
def test_search_reloc_points(seed, th, orb_dist, check_rotation):
    s = scene(seed)
    args = (s["pts_w"], s["mask"], s["pt_desc"], s["min_d"], s["max_d"],
            s["kf_angle"], s["Tcw"], s["xy"], s["octave"], s["desc"],
            s["angle"], s["free"])
    got = matching.search_reloc_points(
        *(T(a) for a in args), *CAM, T(BOUNDS), T(SF), LOG_SF, N_LEVELS,
        th, orb_dist=orb_dist, check_rotation=check_rotation)
    want = jmatching.search_reloc_points(
        *(j(a) for a in args), *CAM, j(BOUNDS), j(SF), LOG_SF, N_LEVELS,
        jnp.float32(th), orb_dist=orb_dist, check_rotation=check_rotation)
    assert_matches_equal(got, want, min_ok=60)
    ok = got.ok.numpy()
    assert not ok[~s["mask"]].any()
    on = np.nonzero(ok[: s["n_on"]])[0]
    assert (got.idx.numpy()[on] == on).all()      # each on its feature


@pytest.mark.parametrize("seed,scale", [(2, 1.0), (3, 1.25), (4, 0.8)])
@pytest.mark.parametrize("th", [10.0, 4.0])
def test_search_by_sim3_projection(seed, scale, th):
    s = scene(seed, n_pts=512, n_live=300, sim3_scale=scale)
    R = s["Tcw"][:3, :3].copy()
    t = s["Tcw"][:3, 3].copy()
    args = (s["pts_w"], s["mask"], s["pt_desc"], s["min_d"] * 0 + 0.01,
            s["max_d"] / 0.95 * 1.05, R, t)
    rest = (s["xy"], s["octave"], s["desc"], s["free"])
    got = matching.search_by_sim3_projection(
        *(T(a) for a in args), torch.tensor(scale), *(T(a) for a in rest),
        *CAM, T(BOUNDS), T(SF), LOG_SF, N_LEVELS, th)
    want = jmatching.search_by_sim3_projection(
        *(j(a) for a in args), jnp.float32(scale), *(j(a) for a in rest),
        *CAM, j(BOUNDS), j(SF), LOG_SF, N_LEVELS, jnp.float32(th))
    assert_matches_equal(got, want, min_ok=40)
    assert not got.ok.numpy()[~s["mask"]].any()


@pytest.mark.parametrize("seed,scale", [(5, 1.0), (6, 1.1)])
def test_search_by_sim3_mutual(seed, scale):
    """Two keyframes seeing the same points: KF1's features sit on the
    projections through T1w, KF2's through T2w; S12 maps camera-2
    coordinates into camera 1."""
    rng = np.random.default_rng(seed)
    n = 300
    n_on = 150
    T1w, T2w = pose(rng), pose(rng, 0.08, 0.3)
    pw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   rng.uniform(4, 9, n)], -1).astype(np.float32)

    def view(Tm, p):
        pc = p @ Tm[:3, :3].T + Tm[:3, 3]
        uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                       FY * pc[:, 1] / pc[:, 2] + CY], -1)
        return pc, uv.astype(np.float32)

    pc1, uv1 = view(T1w, pw)
    pc2_true, _ = view(T2w, pw)
    # keyframe 2's own map holds the same points at a drifted scale
    pc2 = pc2_true / scale
    pw2 = ((pc2 - T2w[:3, 3]) @ T2w[:3, :3]).astype(np.float32)
    uv2 = np.stack([FX * pc2[:, 0] / pc2[:, 2] + CX,
                    FY * pc2[:, 1] / pc2[:, 2] + CY], -1).astype(np.float32)
    # S12: camera-2 coords -> camera-1 coords
    R12 = (T1w[:3, :3] @ T2w[:3, :3].T).astype(np.float32)
    t12 = (T1w[:3, 3] - R12 @ T2w[:3, 3]).astype(np.float32)
    # so that pc1 = R12 @ (scale * pc2) + t12
    desc1 = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)
    desc2 = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)
    desc2[:n_on] = flip_bits(desc1[:n_on], 15, rng)
    perm = rng.permutation(n)               # KF2 stores them shuffled
    inv = np.argsort(perm)
    octv = np.full(n, 2, np.int32)    # inside every predicted band
    d1 = np.linalg.norm(pc1, axis=1).astype(np.float32)
    d2 = np.linalg.norm(pc2, axis=1).astype(np.float32)
    mask1 = rng.random(n) > 0.05
    mask2 = rng.random(n) > 0.05
    side1 = (pw, mask1, desc1, d1 * 0.3, d1 * 1.4, octv, uv1)
    side2 = (pw2[perm], mask2[perm], desc2[perm], d2[perm] * 0.3,
             d2[perm] * 1.4, octv, uv2[perm])
    tail = (T1w, T2w, R12, t12)
    got = matching.search_by_sim3_mutual(
        *(T(a) for a in side1), *(T(a) for a in side2),
        *(T(a) for a in tail), torch.tensor(scale),
        *CAM, T(BOUNDS), T(SF), LOG_SF, N_LEVELS, th=7.5)
    want = jmatching.search_by_sim3_mutual(
        *(j(a) for a in side1), *(j(a) for a in side2),
        *(j(a) for a in tail), jnp.float32(scale),
        *CAM, j(BOUNDS), j(SF), LOG_SF, N_LEVELS, th=7.5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    agree = got[1].numpy()
    idx = got[0].numpy()
    assert (idx[~agree] == -1).all()
    assert agree[:n_on].sum() >= 0.7 * n_on
    # an agreed match of point k lands on KF2's copy of point k
    rows = np.nonzero(agree)[0]
    assert (idx[rows] == inv[rows]).all()
    assert not agree[~mask1].any()
