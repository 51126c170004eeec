"""A reference-scale synthetic ring map and the loop correction driven
over it, for either package's MapStore and LoopCloser.

`build_ring_map` is tests/synthetic.py::build_ring_map with the store
classes passed in instead of imported, so this module imports neither jax
nor torch and chip_smoke.py can load it on a machine without jax.
`correct_ring_loop` is the body of tests/test_scale.py::
TestLoopClosureAtScale::test_correct_loop_and_essential_graph: it closes
the ring's last keyframe onto its first through `_correct_loop` (window
remap, SearchAndFuse, essential graph) and returns what that test checks.
The test below holds this copy against the original.
"""

import time

import numpy as np


def build_ring_map(MapStore, FrameFeatures, K: int, pts_per_kf: int,
                   span: int, n_feat: int, drift_per_kf: float = 0.0,
                   seed: int = 3, **store_kw):
    """K keyframes on a ring of radius 30 m, each spawning pts_per_kf
    world points observed by `span` consecutive keyframes (covisibility
    weight between neighbours ~ (span-1) * pts_per_kf, so strong >= 100
    essential-graph edges exist).  With drift_per_kf > 0 the stored poses
    accumulate translational drift around the ring while points stay
    attached to their birth keyframe's drifted frame: the classic
    pre-loop-closure state.  `store_kw` goes to MapStore (the port's
    takes `device=`).  Returns (store, true_poses[K])."""
    rng = np.random.default_rng(seed)
    ring_r = 30.0
    store = MapStore(n_feat, kf_cap=K + 8,
                     pt_cap=max(1 << 12, 2 * K * pts_per_kf), **store_kw)
    true_poses = []
    drift = np.zeros(3)
    drifted = []
    for k in range(K):
        phi = 2 * np.pi * k / K
        Cw = np.array([ring_r * np.sin(phi), 0.0, ring_r * np.cos(phi)])
        z = np.array([np.sin(phi), 0.0, np.cos(phi)])
        x = np.array([np.cos(phi), 0.0, -np.sin(phi)])
        y = np.cross(z, x)
        Rwc = np.stack([x, y, z], -1)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rwc.T
        T[:3, 3] = -Rwc.T @ Cw
        true_poses.append(T.copy())
        Td = T.copy()
        Td[:3, 3] = -Rwc.T.astype(np.float32) @ (Cw + drift)
        drifted.append(Td)
        drift = drift + np.array([drift_per_kf, 0.0, drift_per_kf * 0.5])

    def feats():
        n = n_feat
        return FrameFeatures(
            xy=rng.uniform(0, 200, (n, 2)).astype(np.float32),
            xy_raw=np.zeros((n, 2), np.float32),
            ur=np.full(n, 1.0, np.float32),
            depth=np.full(n, 5.0, np.float32),
            octave=np.zeros(n, np.int32),
            angle=np.zeros(n, np.float32),
            desc=rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
            valid=np.ones(n, bool),
            node=np.full(n, -1, np.int32),
            word=np.full(n, -1, np.int32),
        )

    kf_ids = [store.add_keyframe(feats(), drifted[k], float(k), k)
              for k in range(K)]
    # points born at each keyframe, in front of its drifted camera,
    # observed by the next `span` keyframes
    next_slot = np.zeros(K, np.int64)
    for k in range(K):
        Td = drifted[k]
        Cw = -Td[:3, :3].T @ Td[:3, 3]
        outward = Td[:3, :3].T @ np.array([0, 0, 1.0])
        for _ in range(pts_per_kf):
            p = (Cw + outward * rng.uniform(4, 8)
                 + rng.normal(0, 1.0, 3))
            pid = store.add_point(p.astype(np.float32), kf_ids[k],
                                  rng.integers(0, 2**32, 8,
                                               dtype=np.uint32))
            for d in range(span):
                ko = k + d
                if ko >= K:
                    break
                slot = int(next_slot[ko])
                if slot >= n_feat:
                    continue
                next_slot[ko] += 1
                store.add_observation(pid, kf_ids[ko], slot)
    for k in range(K):
        store.update_connections(kf_ids[k])
    return store, true_poses


def _center(T):
    return -T[:3, :3].T @ T[:3, 3]


def correct_ring_loop(lc, store, true_poses) -> dict:
    """Close the ring's last keyframe onto keyframe 0 with the corrected
    Sim3 of the last keyframe set to its TRUE pose (undoing the drift),
    through `lc._correct_loop`.  Returns seconds, the last keyframe's
    centre error, the largest point move, and the counts the scale test
    asserts on."""
    kf = int(store.n_kf - 1)
    cand = 0
    T_true = true_poses[kf]
    loop_pts = store.kf_obs[cand][store.kf_obs[cand] >= 0][:64]
    pre_pts = store.pt_pos.copy()
    n_pts_before = int(store.pt_valid.sum())
    t0 = time.perf_counter()
    lc._correct_loop(kf, cand, None, None, 1.0,
                     T_true[:3, :3].astype(np.float64),
                     T_true[:3, 3].astype(np.float64), 1.0,
                     np.asarray(loop_pts))
    dt = time.perf_counter() - t0
    kfs = store.valid_kf_ids()
    live = store.pt_valid[:store.n_pt].nonzero()[0]
    return dict(
        seconds=dt, kf=kf, cand=cand,
        poses_finite=bool(np.isfinite(store.kf_pose[kfs]).all()),
        points_finite=bool(np.isfinite(store.pt_pos[live]).all()),
        loop_edge=cand in store.kf_loop_edges.get(kf, set()),
        moved=float(np.abs(store.pt_pos - pre_pts).max()),
        tail_err=float(np.linalg.norm(
            _center(store.kf_pose[kf]) - _center(true_poses[kf]))),
        points_kept=int(store.pt_valid.sum()) / max(n_pts_before, 1),
    )


def test_builder_matches_the_original():
    """Same seed, same map: every array of the store built here (with the
    JAX package's classes) equals synthetic.build_ring_map's."""
    from orb_slam2_tpu.slam.map_store import FrameFeatures, MapStore
    from orb_slam2_tpu_torch.slam.map_store import MapStore as PortStore
    from synthetic import build_ring_map as original

    kw = dict(K=12, pts_per_kf=6, span=3, n_feat=40, drift_per_kf=0.01)
    a, poses_a = build_ring_map(MapStore, FrameFeatures, **kw)
    b, poses_b = original(**kw)
    np.testing.assert_array_equal(np.stack(poses_a), np.stack(poses_b))
    arrays_a, meta_a = PortStore.state(a)    # the layout of `save`
    arrays_b, meta_b = PortStore.state(b)
    assert arrays_a.keys() == arrays_b.keys()
    for k in arrays_a:
        np.testing.assert_array_equal(arrays_a[k], arrays_b[k], err_msg=k)
    assert meta_a.keys() == meta_b.keys()
