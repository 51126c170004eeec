"""The port's LocalMapper: tests/test_pipeline.py's TestCullingPolicies
and TestStaleMapGuard on it, each also run on the JAX mapper over the
same map with the same result, and the keyframe mirror's ensure /
node_dirty bookkeeping."""

import numpy as np
import pytest
import torch

from orb_slam2_tpu.config import Sensor as JSensor
from orb_slam2_tpu.slam.local_mapping import LocalMapper as JLocalMapper
from orb_slam2_tpu.slam.map_store import FrameFeatures as JFrameFeatures
from orb_slam2_tpu.slam.map_store import MapStore as JMapStore
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.config import Sensor
from orb_slam2_tpu_torch.slam.kf_mirror import KfFeatureMirror
from orb_slam2_tpu_torch.slam.local_mapping import LocalMapper
from orb_slam2_tpu_torch.slam.map_store import FrameFeatures, MapStore
from test_pipeline import make_settings

# per package: (new store, FrameFeatures, Sensor, new mapper)
PACKAGES = {
    "port": (lambda *a, **k: MapStore(*a, device="cpu", **k), FrameFeatures,
             Sensor, lambda s, sensor, store: LocalMapper(
                 convert.settings_from_jax(s), sensor, store, device="cpu")),
    "jax": (JMapStore, JFrameFeatures, JSensor, JLocalMapper),
}


def _ff(cls, rng, n, depth=-1.0):
    return cls(
        xy=rng.uniform(0, 100, (n, 2)).astype(np.float32),
        xy_raw=np.zeros((n, 2), np.float32),
        ur=np.full(n, -1.0, np.float32),
        depth=np.full(n, depth, np.float32),
        octave=np.zeros(n, np.int32),
        angle=np.zeros(n, np.float32),
        desc=rng.integers(0, 2 ** 32, (n, 8)).astype(np.uint32),
        valid=np.ones(n, bool),
        node=np.full(n, -1, np.int32),
        word=np.full(n, -1, np.int32),
    )


def _world(pkg, n_feat=32, n_kf=5, n_pt=20, depth=5.0):
    new_store, ff_cls, sensor, mapper = PACKAGES[pkg]
    rng = np.random.default_rng(3)
    store = new_store(n_feat, kf_cap=8, pt_cap=64)
    kfs = [store.add_keyframe(_ff(ff_cls, rng, n_feat, depth),
                              np.eye(4, dtype=np.float32), float(k), k)
           for k in range(n_kf)]
    pts = [store.add_point(rng.normal(0, 1, 3), kfs[0],
                           rng.integers(0, 2 ** 32, 8).astype(np.uint32))
           for _ in range(n_pt)]
    lm = mapper(make_settings(th_depth=60.0), sensor.STEREO, store)
    return store, lm, kfs, pts


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
class TestCullingPolicies:
    def test_map_point_culling_thresholds(self, pkg):
        store, lm, kfs, pts = _world(pkg)
        bad_ratio, few_obs, good, released = pts[:4]
        for p in (bad_ratio, few_obs, good, released):
            for k in kfs[:4]:
                store.add_observation(p, k, p)
        store.pt_visible[bad_ratio] = 5
        store.pt_found[bad_ratio] = 1
        store.erase_observation(few_obs, kfs[3])
        assert store.pt_n_obs[few_obs] == 3
        store.pt_first_kf[released] = -1
        lm.recent_points = [bad_ratio, few_obs, good, released]
        lm._cull_map_points(kfs[2])
        assert not store.pt_valid[bad_ratio]
        assert not store.pt_valid[few_obs]
        assert store.pt_valid[good]
        assert lm.recent_points == [good]
        lm._cull_map_points(kfs[3])
        assert store.pt_valid[good]
        assert lm.recent_points == []

    def test_keyframe_culling_90pct_redundancy(self, pkg):
        store, lm, kfs, pts = _world(pkg)
        for p in pts:
            for k in kfs:
                store.add_observation(p, k, p)
        for k in kfs:
            store.update_connections(k)
        assert int(store.kf_valid.sum()) == 5
        lm._cull_keyframes(kfs[-1])
        alive = [k for k in kfs if store.kf_valid[k]]
        assert kfs[0] in alive and kfs[-1] in alive
        assert len(alive) == 3, alive
        assert all(store.pt_valid[p] for p in pts)


def _guard_lm():
    store = MapStore(8, kf_cap=4, pt_cap=16, device="cpu")
    return LocalMapper(convert.settings_from_jax(make_settings()),
                       Sensor.STEREO, store, device="cpu"), store


class TestStaleMapGuard:
    def test_triangulate_apply_discards_on_big_change(self):
        lm, store = _guard_lm()
        pend = {"use": [], "packed": None, "B": 0, "guard": lm._map_guard()}
        store.big_change_idx += 1       # loop correction happened
        n_before = store.n_pt
        lm._triangulate_apply(0, pend)  # must not touch pend["packed"]
        assert store.n_pt == n_before

    def test_triangulate_apply_discards_on_reset(self):
        lm, store = _guard_lm()
        pend = {"use": [], "packed": None, "B": 0, "guard": lm._map_guard()}
        lm.store = MapStore(8, kf_cap=4, pt_cap=16, device="cpu")
        lm._triangulate_apply(0, pend)
        assert lm.store.n_pt == 0

    def test_fuse_apply_discards_but_still_refreshes(self):
        lm, store = _guard_lm()
        k = store.add_keyframe(_ff(FrameFeatures, np.random.default_rng(0),
                                   8), np.eye(4, dtype=np.float32), 0.0, 0)
        pend = {"targets": [k], "fwd": None, "rev": None,
                "guard": lm._map_guard()}
        store.big_change_idx += 1
        lm._fuse_neighbors_apply(k, pend)   # no crash, no fusion applied


def test_mirror_ensure_and_node_dirty():
    """ensure() uploads each missing row once and refuses ids past its
    capacity; node_dirty() makes the next ensure() upload the row again
    with the nodes assigned since; clear() forgets every row."""
    rng = np.random.default_rng(1)
    store = MapStore(16, kf_cap=8, pt_cap=16, device="cpu")
    for k in range(3):
        store.add_keyframe(_ff(FrameFeatures, rng, 16, depth=4.0),
                           np.eye(4, dtype=np.float32), float(k), k)
    mir = KfFeatureMirror(16, 4, "cpu")
    assert mir.ensure(store, [0, 2])
    np.testing.assert_array_equal(mir.f32[2, :, 0:2].numpy(), store.kf_xy[2])
    np.testing.assert_array_equal(mir.f32[2, :, 3].numpy(),
                                  store.kf_depth[2])
    np.testing.assert_array_equal(mir.desc[0].numpy().view(np.uint32),
                                  store.kf_desc[0])
    assert (mir.i32[2, :, 1] == -1).all()
    assert not mir._present[1] and mir._present[[0, 2]].all()
    assert not mir.ensure(store, [0, 4])          # beyond capacity

    store.bow_hooks.append(mir.node_dirty)
    node = np.arange(16, dtype=np.int32)
    store.set_kf_bow(2, node, node)
    assert not mir._present[2]
    stale = mir.i32[2, :, 1].clone()
    assert mir.ensure(store, [2])
    assert (stale == -1).all()
    np.testing.assert_array_equal(mir.i32[2, :, 1].numpy(), node)

    mir.clear()
    assert not mir._present.any()
    before = mir.f32.clone()
    assert mir.ensure(store, [0])
    assert torch.equal(mir.f32[0], before[0])   # re-uploaded, same rows


def test_local_ba_reads_its_window_under_the_lock():
    """Local BA reads the covisible window, its points and their
    out-of-window observers under store.lock: the observation engine
    releases the GIL, and the tracking thread writes observations under
    that lock.  Each read is probed from another thread, which must not
    get the lock."""
    import threading

    store, lm, kfs, pts = _world("port")
    for k in kfs[:3]:
        for f, p in enumerate(pts):
            store.add_observation(p, k, f)
    for k in kfs[:3]:
        store.update_connections(k, min_weight=1)
    held = {}

    def probed(name, fn):
        def other(got):
            ok = store.lock.acquire(blocking=False)
            if ok:
                store.lock.release()
            got.append(ok)

        def call(*a, **k):
            got = []
            t = threading.Thread(target=other, args=(got,))
            t.start()
            t.join(10)
            assert not t.is_alive()
            held.setdefault(name, []).append(not got[0])
            return fn(*a, **k)
        return call

    store.ordered_covisibles = probed("covisibles", store.ordered_covisibles)
    store.points_in_kfs = probed("points", store.points_in_kfs)
    store.obs.observers_of = probed("observers", store.obs.observers_of)
    lm.local_bundle_adjustment(kfs[2])
    assert held == {"covisibles": [True], "points": [True],
                    "observers": [True]}, held


class _ResetWhileWaiting:
    """Stands in for the device capture lock: a Tracker.reset lands (the
    queue is emptied) while the worker waits for it."""

    def __init__(self, worker):
        self.worker = worker

    def __enter__(self):
        self.worker.queue.clear()

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("who", ["mapper", "loop_closer"])
def test_a_reset_while_a_worker_waits_for_the_lock(monkeypatch, who):
    """process_one sees a keyframe queued, then waits for the device
    capture lock; a reset that empties the queue meanwhile must leave the
    worker idle, not kill its thread with an IndexError."""
    from orb_slam2_tpu_torch.slam import local_mapping, loop_closing
    from orb_slam2_tpu_torch.slam.loop_closing import LoopCloser

    store, lm, kfs, _ = _world("port")
    if who == "mapper":
        worker, module = lm, local_mapping
    else:
        worker = LoopCloser(convert.settings_from_jax(make_settings()),
                            Sensor.STEREO, store, kf_database=None,
                            local_mapper=None, device="cpu")
        module = loop_closing
    worker.queue.append(kfs[-1])
    monkeypatch.setattr(module, "DEVICE_CAPTURE_LOCK",
                        _ResetWhileWaiting(worker))
    worker.process_one()
    assert not worker.queue and not worker.processing and worker.idle()
