"""Loop closing and global BA of the port on the CPU.

- The drifted ring map of tests/test_scale.py::TestLoopClosureAtScale
  through BOTH packages' `_correct_loop` + `_optimize_essential_graph`
  (window remap, SearchAndFuse, bulk edge assembly, pose graph).  The
  pose-graph problems the two build are bit-equal (checked here); the
  fp32 solves then part with the size of the graph, a ring being weakly
  constrained: at 120 keyframes (128 padded, dense mode) every keyframe
  centre is within 1e-3 m of the JAX package's (4.4e-4 m seen), at 300
  keyframes (512 padded, cg mode, 20 x 1024 CG steps) within 2e-2 m
  (8.4e-3 m seen; 2.7e-3 m already after one LM step, and the dense
  solve of the same problem parts by 1.2e-2 m), both runs ending 0.98 m
  from the undrifted ring.
- `GlobalBA` on a tracked map, as tests/test_system_e2e.py::TestGlobalBA:
  keyframes born mid-run follow the spanning tree, a stopped run is
  discarded, the background thread applies.
- `System.reset` rebinds the loop closer, the relocalizer and the
  database (TestReset).
- The lock order: a mapper pass, a loop-closer pass and a GBA chunk on
  three threads wait for a held capture lock and finish once it is
  released; none deadlocks against another.
"""

import threading

import numpy as np
import pytest
import torch

from orb_slam2_tpu.config import Sensor as JSensor
from orb_slam2_tpu.slam.loop_closing import LoopCloser as JLoopCloser
from orb_slam2_tpu.slam.map_store import FrameFeatures as JFrameFeatures
from orb_slam2_tpu.slam.map_store import MapStore as JMapStore
from orb_slam2_tpu.solvers import pose_graph as jpose_graph
from orb_slam2_tpu_torch import convert, utils
from orb_slam2_tpu_torch.config import Sensor
from orb_slam2_tpu_torch.ops import frontend
from orb_slam2_tpu_torch.places.vocabulary import Vocabulary
from orb_slam2_tpu_torch.slam.global_ba import GlobalBA, _Run
from orb_slam2_tpu_torch.slam.loop_closing import LoopCloser
from orb_slam2_tpu_torch.slam.map_store import FrameFeatures, MapStore
from orb_slam2_tpu_torch.solvers import pose_graph
from orb_slam2_tpu_torch.system import System
from synthetic import CylinderScene, circle_trajectory
from test_system_e2e import BASELINE, H, W, make_settings
from test_torch_ring_map import build_ring_map, correct_ring_loop

torch.set_num_threads(2)

RING = dict(pts_per_kf=30, span=5, drift_per_kf=0.004)
# keyframes -> (max keyframe-centre deviation, max point deviation), m
MAX_DEV_M = {120: (1e-3, 2e-3), 300: (2e-2, 4e-2)}


def centers(poses):
    return -np.einsum("kji,kj->ki", poses[:, :3, :3], poses[:, :3, 3])


# ---------------------------------------------------------------------------
# the ring map through both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=sorted(MAX_DEV_M))
def ring_runs(request):
    K = request.param
    jsettings = make_settings()
    settings = convert.settings_from_jax(jsettings)
    store, true_poses = build_ring_map(
        MapStore, FrameFeatures, K=K, n_feat=settings.n_features,
        device="cpu", **RING)
    jstore, _ = build_ring_map(
        JMapStore, JFrameFeatures, K=K, n_feat=settings.n_features, **RING)
    lc = LoopCloser(settings, Sensor.STEREO, store, kf_database=None,
                    local_mapper=None, device="cpu")
    jlc = JLoopCloser(jsettings, JSensor.STEREO, jstore, kf_database=None,
                      local_mapper=None)
    # keep the pose-graph problem each package builds
    seen = {}

    def spy(module, key):
        inner = module.optimize

        def optimize(prob, **kw):
            seen[key] = (prob, kw)
            return inner(prob, **kw)
        return inner, optimize

    inner, pose_graph.optimize = spy(pose_graph, "port")
    jinner, jpose_graph.optimize = spy(jpose_graph, "jax")
    try:
        out = correct_ring_loop(lc, store, true_poses)
        jout = correct_ring_loop(jlc, jstore, true_poses)
    finally:
        pose_graph.optimize, jpose_graph.optimize = inner, jinner
    return K, store, jstore, out, jout, lc, seen


def test_ring_correction_is_consistent(ring_runs):
    """What TestLoopClosureAtScale asserts, on the port."""
    _, _, _, out, _, lc, _ = ring_runs
    assert out["poses_finite"] and out["points_finite"]
    assert out["loop_edge"]
    assert out["moved"] > 0, "loop correction moved no points"
    assert out["tail_err"] < 1.0, out["tail_err"]
    assert out["points_kept"] > 0.9
    assert out["seconds"] < 300, out["seconds"]
    assert lc.timers.counts["loop/essential_graph"] == 1
    assert lc.timers.counts["loop/search_and_fuse"] == 1


def test_ring_correction_matches_jax(ring_runs):
    K, store, jstore, out, jout, _, seen = ring_runs
    max_kf_dev, max_pt_dev = MAX_DEV_M[K]
    # the same problem went into both solvers, in the same mode
    (prob, kw), (jprob, jkw) = seen["port"], seen["jax"]
    assert kw == jkw and kw["mode"] == ("dense" if K <= 256 else "cg")
    for f in prob._fields:
        np.testing.assert_array_equal(getattr(prob, f).numpy(),
                                      np.asarray(getattr(jprob, f)),
                                      err_msg=f)
    kfs = store.valid_kf_ids()
    np.testing.assert_array_equal(kfs, jstore.valid_kf_ids())
    dev = np.linalg.norm(centers(store.kf_pose[kfs])
                         - centers(jstore.kf_pose[kfs]), axis=1).max()
    assert dev < max_kf_dev, dev
    pids = store.valid_pt_ids()
    np.testing.assert_array_equal(pids, jstore.valid_pt_ids())
    pdev = np.linalg.norm(store.pt_pos[pids] - jstore.pt_pos[pids],
                          axis=1).max()
    assert pdev < max_pt_dev, pdev
    assert abs(out["tail_err"] - jout["tail_err"]) < max_kf_dev
    # the same bindings after SearchAndFuse, the same graph after it
    np.testing.assert_array_equal(store.kf_obs[kfs], jstore.kf_obs[kfs])
    assert store.kf_loop_edges == jstore.kf_loop_edges
    assert store.big_change_idx == jstore.big_change_idx


def test_loop_closer_surface():
    settings = convert.settings_from_jax(make_settings())
    store = MapStore(settings.n_features, device="cpu")
    lc = LoopCloser(settings, Sensor.STEREO, store, kf_database=None,
                    device="cpu")
    assert lc.idle() and not lc.loop_detected and lc.loops_closed == 0
    assert not lc.background_gba and lc.on_loop == []
    lc.insert_keyframe(3)
    assert not lc.idle() and lc.queue == [3]
    lc.spin()            # keyframe 3 is not valid: dropped, no detection
    assert lc.idle() and not lc.processing
    fresh = MapStore(settings.n_features, device="cpu")
    lc.insert_keyframe(1)
    lc.reset(fresh)
    assert lc.store is fresh and not lc.queue and lc.last_loop_kf == -1000
    with pytest.raises(RuntimeError, match="cuda"):
        if torch.cuda.is_available():
            raise RuntimeError("cuda present")
        LoopCloser(settings, Sensor.STEREO, store, kf_database=None,
                   device="cuda")


# ---------------------------------------------------------------------------
# global BA, reset and the lock order on a tracked map
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world():
    jsettings = make_settings()
    scene = CylinderScene(jsettings.K, H, W)
    probe = circle_trajectory(12, orbit_r=2.0, total_angle=2 * np.pi)
    descs = []
    for T in probe:
        d = convert.features_to_numpy(frontend.extract(
            torch.from_numpy(scene.render(T)), n_features=600))
        descs.append(d["desc"][d["valid"]])
    voc = Vocabulary.train(np.concatenate(descs), k=10, L=3, levels_up=1)
    return convert.settings_from_jax(jsettings), scene, voc


TRL = np.eye(4, dtype=np.float32)
TRL[0, 3] = -BASELINE


def build(world, n_first, n_total, **kw):
    settings, scene, voc = world
    sys_ = System(settings, Sensor.STEREO, vocabulary=voc, device="cpu",
                  **kw)
    poses = circle_trajectory(n_total, orbit_r=2.0, total_angle=np.pi * 0.9)
    for i in range(n_first):
        T = poses[i]
        sys_.track_stereo(scene.render(T), scene.render(TRL @ T), i * 0.2)
    return sys_, scene, poses


@pytest.fixture
def tracked20(world):
    return build(world, 20, 20)[0]


class TestGlobalBA:
    """Reference background-GBA protocol (src/LoopClosing.cc:646-757)."""

    def test_mid_gba_keyframes_follow_spanning_tree(self, world):
        sys_, scene, poses = build(world, 28, 44)
        store = sys_.store
        assert int(store.kf_valid.sum()) >= 3
        gba = GlobalBA(sys_.local_mapper)
        buckets_before = dict(sys_.local_mapper._buckets._cur)
        snap = gba._snapshot(loop_kf=0, iters=10, fixed_kf=store.origin_kf)
        assert snap is not None and snap["mode"] == "dense"
        # the snapshot used GBA's own buckets, not the mapper's
        assert sys_.local_mapper._buckets._cur == buckets_before
        fixed = snap["prob"].cam_fixed.numpy()
        n_live = len(snap["cam_index"])
        assert fixed[n_live:].all() and fixed[:n_live].sum() == 1
        assert fixed[snap["cam_index"][store.origin_kf]]
        snap_kfs = set(snap["cam_index"])
        snap_pts = set(int(p) for p in snap["pids"])

        # keyframes + points born "while GBA runs"
        for i in range(28, 44):
            T = poses[i]
            sys_.track_stereo(scene.render(T), scene.render(TRL @ T),
                              i * 0.2)
        born = [int(k) for k in store.valid_kf_ids()
                if int(k) not in snap_kfs]
        assert born, "no keyframe was created after the snapshot"
        pre = {int(k): store.kf_pose[int(k)].copy()
               for k in store.valid_kf_ids()}
        big = store.big_change_idx

        gba._run(snap, _Run())
        assert gba.runs_finished == 1 and store.big_change_idx == big + 1

        # born keyframes moved WITH their spanning-tree parent: the
        # relative pose to the parent is preserved by the correction
        for k in born:
            p = int(store.kf_parent[k])
            assert p >= 0
            rel_before = pre[k] @ np.linalg.inv(pre[p])
            rel_after = store.kf_pose[k] @ np.linalg.inv(store.kf_pose[p])
            np.testing.assert_allclose(rel_after, rel_before, atol=5e-3)
        new_pts = [int(p) for p in store.valid_pt_ids()
                   if int(p) not in snap_pts]
        assert new_pts and np.isfinite(store.pt_pos[new_pts]).all()

    def test_stop_discards_results(self, tracked20):
        store = tracked20.store
        gba = GlobalBA(tracked20.local_mapper)
        snap = gba._snapshot(loop_kf=0, iters=10, fixed_kf=store.origin_kf)
        pre = {int(k): store.kf_pose[int(k)].copy()
               for k in store.valid_kf_ids()}
        r = _Run()
        r.stop = True      # killed before the first chunk (mbStopGBA)
        gba._run(snap, r)
        assert gba.runs_aborted == 1 and gba.runs_finished == 0
        assert not r.alive
        for k, T in pre.items():
            np.testing.assert_array_equal(store.kf_pose[k], T)

    def test_stop_under_store_lock_is_seen_at_apply(self, tracked20):
        """A loop correction kills a run with a plain flag write while it
        holds store.lock; the run rechecks the flag under that lock."""
        store = tracked20.store
        gba = GlobalBA(tracked20.local_mapper)
        snap = gba._snapshot(loop_kf=0, iters=2, fixed_kf=store.origin_kf)
        pre = store.kf_pose.copy()
        r = _Run()
        prob, ok = gba._chunked_optimize(snap["prob"], 2, "dense", r)
        assert ok
        with store.lock:
            r.stop = True
        assert gba._apply(snap, prob, r) is False
        np.testing.assert_array_equal(store.kf_pose, pre)

    def test_background_thread_applies(self, tracked20):
        store = tracked20.store
        mapper = tracked20.local_mapper
        ok = mapper.global_bundle_adjustment(
            iters=10, fixed_kf=store.origin_kf, loop_kf=0, background=True,
            gba=(gba := GlobalBA(mapper)))
        assert ok
        gba.wait()
        assert gba.runs_finished == 1
        assert not gba.running
        kfs = store.valid_kf_ids()
        assert np.isfinite(store.kf_pose[kfs]).all()


def test_reset_rebinds_every_subsystem(world):
    settings, scene, voc = world
    sys_ = System(settings, Sensor.STEREO, vocabulary=voc, device="cpu")
    poses = circle_trajectory(8, orbit_r=2.0, total_angle=0.4)
    for i, T in enumerate(poses):
        sys_.track_stereo(scene.render(T), scene.render(TRL @ T), i * 0.2)
    old_store = sys_.store
    assert int(old_store.kf_valid.sum()) >= 1
    assert sys_.kf_database.bow, "the loop closer enrolled no keyframe"
    # a keyframe of a System with a vocabulary carries its BoW
    kf0 = int(old_store.valid_kf_ids()[0])
    assert old_store.kf_bow_assigned(kf0)

    sys_.reset()
    assert sys_.store is sys_.tracker.store
    assert sys_.store is not old_store
    assert sys_.local_mapper.store is sys_.store
    assert sys_.loop_closer.store is sys_.store
    assert sys_.tracker.relocalizer.store is sys_.store
    assert sys_.tracker.kf_database is sys_.kf_database
    assert not sys_.kf_database.bow
    assert int(sys_.store.kf_valid.sum()) == 0
    assert any(getattr(h, "__self__", None) is sys_.kf_database
               for h in sys_.store.erase_hooks)
    for i, T in enumerate(poses):
        Te = sys_.track_stereo(scene.render(T), scene.render(TRL @ T),
                               50 + i * 0.2)
    assert sys_.tracker.state.name == "OK" and Te is not None
    assert int(sys_.store.kf_valid.sum()) >= 1


def test_localization_mode_visual_odometry_branch(world):
    """Localization mode with mbVO set (few map matches): the Tracker
    runs the motion model and relocalization side by side (ref:
    src/Tracking.cc:345-390); on mapped ground the relocalization wins
    and clears the flag, and no keyframe is inserted."""
    sys_, scene, poses = build(world, 20, 24)
    tracker = sys_.tracker
    n_kf = sys_.store.n_kf
    sys_.activate_localization_mode()
    tracker.vo_flag = True
    tracker.use_fast_path = False          # the modular state machine
    T = poses[20]
    Te = sys_.track_stereo(scene.render(T), scene.render(TRL @ T), 20 * 0.2)
    assert Te is not None and tracker.state.name == "OK"
    assert tracker.timers.counts["relocalize"] == 0     # not LOST: no span
    assert tracker.relocalizations == 1 and not tracker.vo_flag
    assert tracker.last_reloc_frame_id == tracker.current.frame_id
    assert sys_.store.n_kf == n_kf
    sys_.deactivate_localization_mode()
    assert not tracker.only_tracking


def test_workers_wait_for_the_capture_lock_and_none_deadlocks(tracked20):
    """Mapper pass, loop-closer pass and a GBA chunk, each on a thread of
    its own, while this thread holds the capture lock (as a graph capture
    does): none runs before the release, all finish after it.  Each
    takes the capture lock first and store.lock inside (or alone), so
    the three cannot deadlock against one another either."""
    sys_ = tracked20
    store, mapper, lc = sys_.store, sys_.local_mapper, sys_.loop_closer
    kf = int(store.valid_kf_ids()[-1])
    gba = GlobalBA(mapper)
    snap = gba._snapshot(loop_kf=kf, iters=1, fixed_kf=store.origin_kf)
    done = {}

    def mapper_pass():
        mapper.insert_keyframe(kf)
        mapper.process_one()
        done["mapper"] = True

    def loop_pass():
        lc.queue.clear()
        lc.insert_keyframe(kf)
        lc.process_one()
        done["loop"] = True

    def gba_chunk():
        gba._chunked_optimize(snap["prob"], 1, snap["mode"], _Run())
        done["gba"] = True

    threads = [threading.Thread(target=f, daemon=True)
               for f in (mapper_pass, loop_pass, gba_chunk)]
    with utils.DEVICE_CAPTURE_LOCK:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=1.0)
        assert not done, f"ran inside a capture: {sorted(done)}"
        assert all(t.is_alive() for t in threads)
        # the capturing thread may still take store.lock meanwhile
        assert store.lock.acquire(timeout=1.0)
        store.lock.release()
    for t in threads:
        t.join(timeout=120.0)
    assert not any(t.is_alive() for t in threads), "deadlock"
    assert sorted(done) == ["gba", "loop", "mapper"]
    lc.spin()     # the mapper's pass handed its keyframe on to the closer
    assert mapper.idle() and lc.idle()
