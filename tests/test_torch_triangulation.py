"""Triangulation, the BoW / triangulation matchers and Fuse of the port
against the JAX package on the same seeded inputs (CPU).

Integer outputs (match indices, ok / good masks) must be equal; points
within 1e-3 m + 3e-4 of their distance (float32 DLT: a near-parallel
pair's 3x3 normal equations amplify last-ulp differences along the ray);
the batched and mirror forms must equal each other exactly."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from orb_slam2_tpu.ops import matching as jm
from orb_slam2_tpu.solvers import triangulation as jt
from orb_slam2_tpu_torch.ops import matching as tm
from orb_slam2_tpu_torch.slam.kf_mirror import KfFeatureMirror
from orb_slam2_tpu_torch.solvers import triangulation as tt

torch.set_num_threads(2)

FX = FY = 260.0
CX, CY = 160.0, 120.0
BF = 26.0
W, H = 320, 240
N = 256
SF = (1.2 ** np.arange(8)).astype(np.float32)
LS2 = (SF ** 2).astype(np.float32)
PTS_ATOL, PTS_RTOL = 1e-3, 3e-4


def _close_pts(a, b):
    err = np.linalg.norm(a - b, axis=-1)
    bound = PTS_ATOL + PTS_RTOL * np.linalg.norm(b, axis=-1)
    assert (err <= bound).all(), (err.max(), (err / bound).max())


def _pose(rng, center, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    Rwc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rwc.T
    T[:3, 3] = -Rwc.T @ np.asarray(center)
    return T


def _view(rng, T, pts, desc, stereo_share=0.6, flips=4):
    """A keyframe's feature block seeing `pts` from pose T: projections
    with sub-pixel noise, octaves, right-u for a share of them, and the
    points' descriptors with a few bits flipped."""
    pc = pts @ T[:3, :3].T + T[:3, 3]
    u = FX * pc[:, 0] / pc[:, 2] + CX + rng.normal(0, 0.3, len(pts))
    v = FY * pc[:, 1] / pc[:, 2] + CY + rng.normal(0, 0.3, len(pts))
    order = rng.permutation(len(pts))[:N]
    n = len(order)
    xy = np.zeros((N, 2), np.float32)
    xy[:n] = np.stack([u, v], -1)[order]
    valid = np.zeros(N, bool)
    valid[:n] = ((xy[:n, 0] > 5) & (xy[:n, 0] < W - 5) & (xy[:n, 1] > 5)
                 & (xy[:n, 1] < H - 5) & (pc[order, 2] > 0.5))
    octave = rng.integers(0, 3, N).astype(np.int32)
    depth = np.full(N, -1.0, np.float32)
    ur = np.full(N, -1.0, np.float32)
    st = valid & (rng.uniform(0, 1, N) < stereo_share)
    depth[:n][st[:n]] = pc[order, 2][st[:n]]
    ur[st] = xy[st, 0] - BF / depth[st]
    d = np.zeros((N, 8), np.uint32)
    d[:n] = desc[order]
    for _ in range(flips):
        w = rng.integers(0, 8, N)
        b = rng.integers(0, 32, N).astype(np.uint32)
        d[np.arange(N), w] ^= (np.uint32(1) << b)
    angle = (rng.normal(40.0, 2.0, N) % 360).astype(np.float32)
    return dict(xy=xy, ur=ur, depth=depth, octave=octave, desc=d,
                node=np.full(N, -1, np.int32), angle=angle, valid=valid,
                free=valid.copy())


def _scene(seed, n_nb):
    rng = np.random.default_rng(seed)
    P = 400
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                    rng.uniform(4, 9, P)], -1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint32)
    T1 = _pose(rng, [0.0, 0.0, 0.0], 0.0)
    kf1 = _view(rng, T1, pts, desc)
    nbs = []
    for b in range(n_nb):
        T2 = _pose(rng, [0.25 * (b + 1), 0.02 * b, 0.05 * b], 0.01 * (b + 1))
        nbs.append((T2, _view(rng, T2, pts, desc)))
    return T1, kf1, nbs


def _fundamental_epipole(T1, T2):
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    F = np.asarray(jt.fundamental_from_poses(jnp.asarray(T1), jnp.asarray(T2),
                                             jnp.asarray(K), jnp.asarray(K)))
    O1 = -T1[:3, :3].T @ T1[:3, 3]
    pc = T2[:3, :3] @ O1 + T2[:3, 3]
    ep = np.array([FX * pc[0] / pc[2] + CX, FY * pc[1] / pc[2] + CY],
                  np.float32)
    return F, ep


def _T(a):
    return torch.from_numpy(np.array(a))


def _td(a):
    a = np.ascontiguousarray(a)
    return _T(a.view(np.int32) if a.dtype == np.uint32 else a)


TRI_FIELDS = ("xy", "ur", "octave", "desc", "node", "angle", "free")


@pytest.mark.parametrize("seed", [0, 1])
def test_search_for_triangulation_matches_jax(seed):
    T1, f1, nbs = _scene(seed, 1)
    T2, f2 = nbs[0]
    F, ep = _fundamental_epipole(T1, T2)
    args1 = [f1[k] for k in TRI_FIELDS]
    args2 = [f2[k] for k in TRI_FIELDS]
    jr = jm.search_for_triangulation(
        *[jnp.asarray(a) for a in args1], *[jnp.asarray(a) for a in args2],
        jnp.asarray(F), jnp.asarray(ep), jnp.asarray(SF), jnp.asarray(LS2))
    tr = tm.search_for_triangulation(
        *[_td(a) for a in args1], *[_td(a) for a in args2],
        _T(F), _T(ep), _T(SF), _T(LS2))
    ok = np.asarray(jr.ok)
    assert ok.sum() > 30
    np.testing.assert_array_equal(tr.ok.numpy(), ok)
    np.testing.assert_array_equal(tr.idx.numpy()[ok], np.asarray(jr.idx)[ok])


@pytest.mark.parametrize("seed", [0, 1])
def test_search_by_nodes_matches_jax(seed):
    """The reference-keyframe matcher with no vocabulary (every node -1):
    brute force, TH_LOW, ratio 0.7, rotation histogram."""
    _, f1, nbs = _scene(seed, 1)
    f2 = nbs[0][1]
    keys = ("desc", "node", "valid", "angle")
    jr = jm.search_by_nodes(*[jnp.asarray(f1[k]) for k in keys],
                            *[jnp.asarray(f2[k]) for k in keys], ratio=0.7)
    tr = tm.search_by_nodes(*[_td(f1[k]) for k in keys],
                            *[_td(f2[k]) for k in keys], ratio=0.7)
    ok = np.asarray(jr.ok)
    assert ok.sum() > 30
    np.testing.assert_array_equal(tr.ok.numpy(), ok)
    np.testing.assert_array_equal(tr.idx.numpy()[ok], np.asarray(jr.idx)[ok])
    np.testing.assert_array_equal(tr.dist.numpy()[ok],
                                  np.asarray(jr.dist)[ok])


def test_triangulate_and_gate_matches_jax():
    T1, f1, nbs = _scene(2, 1)
    T2, f2 = nbs[0]
    F, ep = _fundamental_epipole(T1, T2)
    m = jm.search_for_triangulation(
        *[jnp.asarray(f1[k]) for k in TRI_FIELDS],
        *[jnp.asarray(f2[k]) for k in TRI_FIELDS],
        jnp.asarray(F), jnp.asarray(ep), jnp.asarray(SF), jnp.asarray(LS2))
    idx, ok = np.asarray(m.idx), np.asarray(m.ok)
    args = (T1, T2, f1["xy"], f2["xy"][idx], f1["ur"], f2["ur"][idx],
            f1["depth"], f2["depth"][idx], f1["octave"], f2["octave"][idx],
            ok)
    jr = jt.triangulate_and_gate(*[jnp.asarray(a) for a in args],
                                 FX, FY, CX, CY, BF, jnp.asarray(SF),
                                 jnp.asarray(LS2))
    tr = tt.triangulate_and_gate(*[_td(a) for a in args], FX, FY, CX, CY, BF,
                                 _T(SF), _T(LS2))
    good = np.asarray(jr.good)
    assert good.sum() > 20
    np.testing.assert_array_equal(tr.good.numpy(), good)
    _close_pts(tr.pts_w.numpy()[good], np.asarray(jr.pts_w)[good])


def _batch_inputs(seed, B_used, B):
    T1, f1, nbs = _scene(seed, B_used)
    T2_b = np.stack([T for T, _ in nbs] + [np.eye(4, dtype=np.float32)]
                    * (B - B_used))
    stk = {k: np.stack([f[k] for _, f in nbs] + [nbs[-1][1][k]]
                       * (B - B_used))
           for k in ("xy", "ur", "depth", "octave", "desc", "node", "angle")}
    free2 = np.stack([f["free"] for _, f in nbs]
                     + [np.zeros(N, bool)] * (B - B_used))
    nb_mask = np.zeros(B, bool)
    nb_mask[:B_used] = True
    return T1, f1, nbs, T2_b, stk, free2, nb_mask


def test_triangulate_batch_and_gather_match_jax():
    """The stacked and the mirror entry points give the same packed
    proposals as each other and as the JAX triangulate_batch."""
    B = 4
    T1, f1, nbs, T2_b, stk, free2, nb_mask = _batch_inputs(3, 3, B)
    one = ("xy", "ur", "depth", "octave", "desc", "node", "angle", "free")
    two = ("xy", "ur", "depth", "octave", "desc", "node", "angle")
    jp = np.asarray(jt.triangulate_batch(
        jnp.asarray(T1), *[jnp.asarray(f1[k]) for k in one],
        jnp.asarray(T2_b), *[jnp.asarray(stk[k]) for k in two],
        jnp.asarray(free2), jnp.asarray(nb_mask),
        FX, FY, CX, CY, BF, jnp.asarray(SF), jnp.asarray(LS2)))
    tp = tt.triangulate_batch(
        _T(T1), *[_td(f1[k]) for k in one], _T(T2_b),
        *[_td(stk[k]) for k in two], _T(free2), _T(nb_mask),
        FX, FY, CX, CY, BF, _T(SF), _T(LS2))
    ji, jg, jpts = jt.unpack_triangulate_batch(jp, B, N)
    ti, tg, tpts = tt.unpack_triangulate_batch(tp, B, N)
    assert jg.sum() > 60 and not jg[3:].any()
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(ti[tg], ji[jg])
    _close_pts(tpts[tg], jpts[jg])

    # the mirror path: rows 5 (current) and 7, 9, 11 (neighbours)
    class Store:
        pass

    st = Store()
    rows = {5: f1, 7: nbs[0][1], 9: nbs[1][1], 11: nbs[2][1]}
    cap_n = 12
    for k, name in (("xy", "kf_xy"), ("ur", "kf_ur"), ("depth", "kf_depth"),
                    ("angle", "kf_angle"), ("octave", "kf_octave"),
                    ("node", "kf_node"), ("desc", "kf_desc"),
                    ("valid", "kf_feat_valid")):
        a = np.zeros((cap_n,) + f1[k].shape, f1[k].dtype)
        for r, f in rows.items():
            a[r] = f[k]
        setattr(st, name, a)
    mir = KfFeatureMirror(N, 16, "cpu")
    assert mir.ensure(st, [5, 7, 9, 11])
    assert not mir.ensure(st, [5, 16])
    ids = torch.tensor([7, 9, 11, 11])
    gp = tt.triangulate_gather(
        _T(T1), _T(T2_b), 5, ids, _td(f1["node"]), mir.f32, mir.i32,
        mir.desc, _T(f1["free"]), _T(free2), _T(nb_mask),
        FX, FY, CX, CY, BF, _T(SF), _T(LS2))
    assert torch.equal(gp, tp)


def _fuse_inputs(seed):
    rng = np.random.default_rng(seed)
    T1, f1, nbs = _scene(seed, 2)
    M = 192
    pts = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M),
                    rng.uniform(4, 9, M)], -1).astype(np.float32)
    # points near the keyframe's own stereo back-projections, so fusion
    # has candidates
    has = np.nonzero(f1["valid"] & (f1["depth"] > 0))[0][:M]
    z = f1["depth"][has]
    pc = np.stack([(f1["xy"][has, 0] - CX) / FX * z,
                   (f1["xy"][has, 1] - CY) / FY * z, z], -1)
    pts[: len(has)] = ((pc - T1[:3, 3]) @ T1[:3, :3]).astype(np.float32)
    mask = np.ones(M, bool)
    mask[-7:] = False
    desc = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint32)
    desc[: len(has)] = f1["desc"][has]
    normal = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    dist = np.linalg.norm(pts, axis=1)
    # predicted level ceil(log(1.1) / log(1.2)) = 1: octaves 0-1 match
    max_d = (dist * 1.1).astype(np.float32)
    min_d = (max_d / SF[-1]).astype(np.float32)
    pt_args = (pts, mask, desc, normal.astype(np.float32), min_d, max_d)
    return T1, f1, nbs, pt_args


SCALARS = dict(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF)
BOUNDS = np.array([0, W, 0, H], np.float32)


def test_fuse_points_matches_jax():
    T1, f1, _, pt_args = _fuse_inputs(4)
    kf = [f1[k] for k in ("xy", "ur", "octave", "desc", "valid")]
    jr = jm.fuse_points(*[jnp.asarray(a) for a in pt_args], jnp.asarray(T1),
                        *[jnp.asarray(a) for a in kf], FX, FY, CX, CY, BF,
                        jnp.asarray(BOUNDS), jnp.asarray(SF),
                        jnp.asarray(LS2), float(np.log(1.2)), 8)
    tr = tm.fuse_points(*[_td(a) for a in pt_args], _T(T1),
                        *[_td(a) for a in kf], FX, FY, CX, CY, BF,
                        _T(BOUNDS), _T(SF), _T(LS2), float(np.log(1.2)), 8)
    ok = np.asarray(jr.ok)
    assert ok.sum() > 20
    np.testing.assert_array_equal(tr.ok.numpy(), ok)
    np.testing.assert_array_equal(tr.idx.numpy()[ok], np.asarray(jr.idx)[ok])


def test_fuse_points_batch_and_gather_match_jax():
    T1, f1, nbs, pt_args = _fuse_inputs(5)
    M = len(pt_args[0])
    B = 4
    targets = [(T1, f1)] + list(nbs)
    Tb = np.stack([T for T, _ in targets] + [np.eye(4, dtype=np.float32)])
    keys = ("xy", "ur", "octave", "desc", "valid")
    stk = [np.stack([f[k] for _, f in targets] + [targets[-1][1][k]])
           for k in keys]
    kmask = np.array([True, True, True, False])
    tail = (FX, FY, CX, CY, BF)
    jp = np.asarray(jm.fuse_points_batch(
        *[jnp.asarray(a) for a in pt_args], jnp.asarray(Tb),
        *[jnp.asarray(a) for a in stk], jnp.asarray(kmask), *tail,
        jnp.asarray(BOUNDS), jnp.asarray(SF), jnp.asarray(LS2),
        float(np.log(1.2)), 8))
    tp = tm.fuse_points_batch(
        *[_td(a) for a in pt_args], _T(Tb), *[_td(a) for a in stk],
        _T(kmask), *tail, _T(BOUNDS), _T(SF), _T(LS2), float(np.log(1.2)), 8)
    ji, jo = jm.unpack_fuse_batch(jp, B, M)
    ti, to = tm.unpack_fuse_batch(tp, B, M)
    assert jo.sum() > 20 and not jo[3].any()
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ti[to], ji[jo])

    # the batch row of a target equals fuse_points on that target alone
    kf = [_td(targets[1][1][k]) for k in keys]
    one = tm.fuse_points(*[_td(a) for a in pt_args], _T(targets[1][0]), *kf,
                         *tail, _T(BOUNDS), _T(SF), _T(LS2),
                         float(np.log(1.2)), 8)
    np.testing.assert_array_equal(one.ok.numpy(), to[1])

    class Store:
        pass

    st = Store()
    for k, name in (("xy", "kf_xy"), ("ur", "kf_ur"), ("depth", "kf_depth"),
                    ("angle", "kf_angle"), ("octave", "kf_octave"),
                    ("node", "kf_node"), ("desc", "kf_desc"),
                    ("valid", "kf_feat_valid")):
        setattr(st, name, np.stack([f[k] for _, f in targets]))
    mir = KfFeatureMirror(N, 8, "cpu")
    mir.ensure(st, [0, 1, 2])
    gp = tm.fuse_points_gather(
        *[_td(a) for a in pt_args], _T(Tb), torch.tensor([0, 1, 2, 2]),
        mir.f32, mir.i32, mir.desc, mir.valid, _T(kmask), *tail,
        _T(BOUNDS), _T(SF), _T(LS2), float(np.log(1.2)), 8)
    assert torch.equal(gp, tp)
