"""The port's MapStore: tests/test_pipeline.py's TestMapStore on it, the
device cache of keyframe features, and maps carried across packages — a
map saved by the JAX package's MapStore.save loads in the port with
equal arrays and observations, and the reverse; `map_store_from_jax`
reads a live JAX store the same way."""

import numpy as np
import pytest
import torch

from orb_slam2_tpu.slam.map_store import FrameFeatures as JFrameFeatures
from orb_slam2_tpu.slam.map_store import MapStore as JMapStore
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.slam.map_store import FrameFeatures, MapStore

N = 8


def _ff(n=N, cls=FrameFeatures, seed=0, ur=-1.0):
    return cls(
        xy=np.zeros((n, 2), np.float32),
        xy_raw=np.zeros((n, 2), np.float32),
        ur=np.full(n, ur, np.float32),
        depth=np.full(n, -1.0, np.float32),
        octave=np.zeros(n, np.int32),
        angle=np.zeros(n, np.float32),
        desc=np.random.default_rng(seed).integers(
            0, 2 ** 32, (n, 8)).astype(np.uint32),
        valid=np.ones(n, bool),
        node=np.full(n, -1, np.int32),
        word=np.full(n, -1, np.int32),
    )


def _store():
    return MapStore(N, kf_cap=4, pt_cap=16, device="cpu"), _ff()


class TestMapStore:
    def test_observation_lifecycle(self):
        m, ff = _store()
        k0 = m.add_keyframe(ff, np.eye(4, dtype=np.float32), 0.0, 0)
        k1 = m.add_keyframe(ff, np.eye(4, dtype=np.float32), 1.0, 1)
        p = m.add_point(np.zeros(3), k0, ff.desc[0])
        m.add_observation(p, k0, 0)
        m.add_observation(p, k1, 3)
        assert m.pt_n_obs[p] == 2
        assert m.kf_obs[k0, 0] == p and m.kf_obs[k1, 3] == p
        m.erase_observation(p, k0)
        # <= 2 obs -> point dies (mono counting)
        assert not m.pt_valid[p]
        assert m.kf_obs[k1, 3] == -1

    def test_replace_point(self):
        m, ff = _store()
        k0 = m.add_keyframe(ff, np.eye(4, dtype=np.float32), 0.0, 0)
        k1 = m.add_keyframe(ff, np.eye(4, dtype=np.float32), 1.0, 1)
        k2 = m.add_keyframe(ff, np.eye(4, dtype=np.float32), 2.0, 2)
        a = m.add_point(np.zeros(3), k0, ff.desc[0])
        b = m.add_point(np.ones(3), k0, ff.desc[1])
        for kf, feat in ((k0, 0), (k1, 1), (k2, 2)):
            m.add_observation(a, kf, feat)
        m.add_observation(b, k0, 5)
        m.replace_point(b, a)
        assert not m.pt_valid[b]
        assert m.resolve_replaced(b) == a
        assert m.kf_obs[k0, 5] == -1
        assert m.obs.find(a, k0) == 0

    def test_batched_point_update_matches_scalar(self):
        rng = np.random.default_rng(7)
        n_feat, n_kf, n_pt = 32, 5, 20
        m = MapStore(n_feat, kf_cap=8, pt_cap=64, device="cpu")
        scale_factors = 1.2 ** np.arange(8)
        kfs = []
        for k in range(n_kf):
            ff = _ff(n_feat, seed=k)
            ff.xy = rng.uniform(0, 100, (n_feat, 2)).astype(np.float32)
            ff.octave = rng.integers(0, 8, n_feat).astype(np.int32)
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = rng.normal(0, 2, 3)
            kfs.append(m.add_keyframe(ff, T, float(k), k))
        pids = []
        feat_next = {k: 0 for k in kfs}
        for _ in range(n_pt):
            ref = kfs[rng.integers(0, n_kf)]
            p = m.add_point(rng.normal(0, 5, 3).astype(np.float32), ref,
                            np.zeros(8, np.uint32))
            for k in rng.permutation(kfs)[:rng.integers(1, n_kf + 1)]:
                m.add_observation(p, int(k), feat_next[int(k)])
                feat_next[int(k)] += 1
            pids.append(p)
        pids = np.array(pids)
        for pid in pids:
            m.update_normal_and_depth(int(pid))
            m.update_scale_band(int(pid), scale_factors)
        ref_normal = m.pt_normal[pids].copy()
        ref_max = m.pt_max_dist[pids].copy()
        ref_min = m.pt_min_dist[pids].copy()
        m.pt_normal[pids] = 0
        m.pt_max_dist[pids] = -1
        m.pt_min_dist[pids] = -1
        m.update_points_batch(pids, scale_factors)
        np.testing.assert_allclose(m.pt_normal[pids], ref_normal,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(m.pt_max_dist[pids], ref_max, rtol=1e-5)
        np.testing.assert_allclose(m.pt_min_dist[pids], ref_min, rtol=1e-5)

    def test_covisibility_and_spanning_tree(self):
        m, ff = _store()
        k0 = m.add_keyframe(ff, np.eye(4, dtype=np.float32), 0.0, 0)
        k1 = m.add_keyframe(ff, np.eye(4, dtype=np.float32), 1.0, 1)
        m.origin_kf = k0
        for i in range(6):
            p = m.add_point(np.zeros(3), k0, ff.desc[i])
            m.add_observation(p, k0, i)
            m.add_observation(p, k1, i)
        m.update_connections(k1, min_weight=3)
        assert m.covis[k1][k0] == 6
        assert m.covis[k0][k1] == 6
        assert m.kf_parent[k1] == k0
        assert k1 in m.kf_children[k0]


def test_kf_device_caches_descriptor_bits_on_the_store_device():
    m, ff = _store()
    k = m.add_keyframe(ff, np.eye(4, dtype=np.float32), 0.0, 0)
    d = m.kf_device(k, "desc")
    assert d.dtype == torch.int32 and d.device == m.device
    np.testing.assert_array_equal(d.numpy().view(np.uint32), ff.desc)
    assert m.kf_device(k, "desc") is d
    assert m.kf_device(k, "valid").dtype == torch.bool


def _fill(m, ff_cls, seed=3):
    """The same small map in either package's store: 3 keyframes, 12
    points, stereo and mono observations, covisibility, one culled
    point."""
    rng = np.random.default_rng(seed)
    for k in range(3):
        ff = _ff(16, ff_cls, seed=k, ur=5.0 if k == 1 else -1.0)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.1 * k, 0.0, 0.0]
        m.add_keyframe(ff, T, 0.1 * k, k)
    for i in range(12):
        p = m.add_point(rng.normal(0, 3, 3).astype(np.float32), 0,
                        rng.integers(0, 2 ** 32, 8, dtype=np.uint32))
        for k in range(3):
            m.add_observation(p, k, i)
    m.set_point_bad(5)
    for k in range(3):
        m.update_connections(k, min_weight=3)
    return m


def _assert_same_map(a, b):
    arrays_a = {k: v for k, v in vars(a).items() if isinstance(v, np.ndarray)}
    arrays_b = {k: v for k, v in vars(b).items() if isinstance(v, np.ndarray)}
    assert arrays_a.keys() == arrays_b.keys()
    for k in arrays_a:
        np.testing.assert_array_equal(arrays_a[k], arrays_b[k], err_msg=k)
        assert arrays_a[k].dtype == arrays_b[k].dtype, k
    for k in ("n_feat", "n_kf", "n_pt", "kf_cap", "pt_cap", "origin_kf",
              "big_change_idx", "covis", "kf_children", "kf_loop_edges"):
        assert getattr(a, k) == getattr(b, k), k
    for pid in np.nonzero(a.pt_valid[: a.n_pt])[0]:
        assert a.obs.items(int(pid)) == b.obs.items(int(pid))
        assert a.obs.n_obs(int(pid)) == b.obs.n_obs(int(pid))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_saved_map_loads_in_the_other_package(direction, tmp_path):
    jm = _fill(JMapStore(16, kf_cap=4, pt_cap=16), JFrameFeatures)
    tm = _fill(MapStore(16, kf_cap=4, pt_cap=16, device="cpu"),
               FrameFeatures)
    _assert_same_map(jm, tm)
    path = str(tmp_path / "map.pkl")
    if direction == "jax_to_port":
        jm.save(path)
        _assert_same_map(MapStore.load(path, device="cpu"), jm)
    else:
        tm.save(path)
        _assert_same_map(JMapStore.load(path), tm)
    # the same bytes either way
    jm.save(str(tmp_path / "j.pkl"))
    tm.save(str(tmp_path / "t.pkl"))
    assert (tmp_path / "j.pkl").read_bytes() == (tmp_path / "t.pkl") \
        .read_bytes()


def test_map_store_from_jax_reads_a_live_store():
    jm = _fill(JMapStore(16, kf_cap=4, pt_cap=16), JFrameFeatures)
    tm = convert.map_store_from_jax(jm, device="cpu")
    _assert_same_map(tm, jm)
    assert tm.device == torch.device("cpu")
    tm.pt_pos[0] += 1.0          # a copy, not a view of the JAX store
    assert not np.array_equal(tm.pt_pos[0], jm.pt_pos[0])
