"""The fork's 2D occupancy grid (mapping2d/gridmap.py, copied into the
port) and its keyframe stream (mapping2d/stream.py) on the port's
MapStore, and the port's `System.change_calibration`.

- tests/test_places.py::TestGridMap on the port's MapStore: the live grid
  against the scalar transliteration of Monosub's loops (that file's
  `_scalar_monosub`), the integer-division quirk, the offline grid and
  `save_grid_map_tum` cell for cell against the JAX package's functions,
  which test_places holds to the C++ semantics.
- The MapStream contract: a keyframe's payload is (kf, camera centre, its
  live points), the whole map is republished every `all_pts_gap`
  keyframes and on a loop, and `attach_grid_mapper`'s grid follows.
- tests/test_system_e2e.py::TestChangeCalibration on the port's System.
"""

import types

import numpy as np
import pytest
import torch

import test_places
from orb_slam2_tpu.mapping2d import gridmap as jgridmap
from orb_slam2_tpu.slam.map_store import FrameFeatures as JFrameFeatures
from orb_slam2_tpu.slam.map_store import MapStore as JMapStore
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.config import Sensor
from orb_slam2_tpu_torch.mapping2d import gridmap, stream
from orb_slam2_tpu_torch.ops import frontend
from orb_slam2_tpu_torch.places.vocabulary import Vocabulary
from orb_slam2_tpu_torch.slam.map_store import FrameFeatures, MapStore
from orb_slam2_tpu_torch.system import System
from synthetic import CylinderScene, circle_trajectory
from test_system_e2e import BASELINE, FX, FY, H, W, make_settings

torch.set_num_threads(2)


def features(n, cls=FrameFeatures):
    return cls(
        xy=np.zeros((n, 2), np.float32),
        xy_raw=np.zeros((n, 2), np.float32),
        ur=np.full(n, 1.0, np.float32),
        depth=np.full(n, 1.0, np.float32),
        octave=np.zeros(n, np.int32),
        angle=np.zeros(n, np.float32),
        desc=np.zeros((n, 8), np.uint32),
        valid=np.ones(n, bool),
        node=np.full(n, -1, np.int32),
        word=np.full(n, -1, np.int32),
    )


def store_with_wall():
    """TestGridMap._store_with_wall on the port's MapStore."""
    n = 8
    m = MapStore(n, kf_cap=4, pt_cap=64, device="cpu")
    ff = features(n)
    kf = m.add_keyframe(ff, np.eye(4, dtype=np.float32), 0.0, 0)
    for i, x in enumerate(np.linspace(-2, 2, n)):
        pid = m.add_point(np.array([x, 0.0, 5.0]), kf, ff.desc[i])
        m.add_observation(pid, kf, i)
    return m


def random_map(seed=7, n_kf=5, n_pts=80):
    """TestGridMap._random_map on the port's MapStore."""
    rng = np.random.default_rng(seed)
    n = 16
    m = MapStore(n, kf_cap=max(8, n_kf), pt_cap=max(128, n_pts * 2),
                 device="cpu")
    ff = features(n)
    kfs = []
    for k in range(n_kf):
        c = rng.uniform(-6, 6, 3)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = -c.astype(np.float32)
        kfs.append(m.add_keyframe(ff, T, float(k), 0))
    for i in range(n_pts):
        p = rng.uniform(-14, 14, 3).astype(np.float32)
        pid = m.add_point(p, kfs[i % n_kf], ff.desc[0])
        for k in kfs:
            if rng.random() < 0.5:
                m.add_observation(pid, k, i % n)
    return m


def test_grid_builds_free_and_occupied():
    m = store_with_wall()
    p = gridmap.GridParams(scale_factor=2.0, cloud_min_x=-10, cloud_max_x=10,
                           cloud_min_z=-10, cloud_max_z=10)
    g = gridmap.GridMapper(m, p)
    g.update_keyframe(0)
    occ = g.occupancy()
    assert (occ == 255).sum() > 5, "expected free cells"
    assert (occ[29] == 0).sum() >= 4, "expected occupied wall cells"
    assert (occ[35] == 128).all()


@pytest.mark.parametrize("use_local", [False, True])
def test_gridmapper_matches_scalar_monosub(use_local):
    p = gridmap.GridParams(scale_factor=4.0, cloud_min_x=-10,
                           cloud_max_x=10, cloud_min_z=-10, cloud_max_z=10,
                           use_local_counters=use_local)
    m = random_map(seed=11 + use_local)
    g = gridmap.GridMapper(m, p)
    g.rebuild()
    want_v, want_o = test_places.TestGridMap._scalar_monosub(m, p)
    np.testing.assert_array_equal(g.visited, want_v)
    np.testing.assert_array_equal(g.occupied, want_o)
    # and the JAX package's GridMapper on the same map
    jg = jgridmap.GridMapper(m, jgridmap.GridParams(**vars(p)))
    jg.rebuild()
    np.testing.assert_array_equal(g.occupancy(), jg.occupancy())


def test_gridmap_int_division_quirk():
    g = gridmap.GridMapper.__new__(gridmap.GridMapper)
    g.p = gridmap.GridParams()
    g.visited = np.array([[10, 10, 0]], np.int64)
    g.occupied = np.array([[6, 10, 0]], np.int64)
    assert g.occupancy().tolist() == [[255, 0, 128]]
    assert g.ros_occupancy_data().tolist() == [[0, 100, 50]]


def test_offline_grid_matches_jax(tmp_path):
    """grid_from_timestamped_points on test_places' inputs: equal to the
    JAX package's, which test_places holds to the scalar script."""
    rng = np.random.default_rng(5)
    kf_ts = [1.0, 2.0, 3.0]
    kf_pos = {t: rng.uniform(-4, 4, 3) for t in kf_ts}
    pts = [rng.uniform(-8, 8, 3) for _ in range(40)]
    obs = [[t for t in kf_ts if rng.random() < 0.7] for _ in pts]
    ptf = tmp_path / "pts.txt"
    with open(ptf, "w") as f:
        for p_, o in zip(pts, obs):
            f.write(" ".join(f"{v:.6f}" for v in p_)
                    + "".join(f" {t:.4f}" for t in o) + "\n")
    kff = tmp_path / "kf.txt"
    with open(kff, "w") as f:
        for t in kf_ts:
            x, y, z = kf_pos[t]
            f.write(f"{t:.4f} {x:.6f} {y:.6f} {z:.6f} 0 0 0 1\n")
    got = gridmap.grid_from_timestamped_points(
        str(ptf), kf_trajectory_path=str(kff))
    want = jgridmap.grid_from_timestamped_points(
        str(ptf), kf_trajectory_path=str(kff))
    assert (got == 255).any() and (got == 128).any()
    np.testing.assert_array_equal(got, want)


def test_save_grid_map_tum_matches_jax_cell_for_cell(tmp_path):
    """test_places' SaveGridMapTUM scene built in a JAX MapStore, copied
    into the port's: the two packages' files are byte-identical, and
    System.save_grid_map_tum writes the same 450x300 file."""
    rng = np.random.default_rng(3)
    n = 16
    jm = JMapStore(n)
    ff = features(n, JFrameFeatures)
    centers = [(-0.5, -1.0, 0.0), (1.0, 0.2, 0.5), (2.5, -2.0, 1.0),
               (9.0, 9.0, 0.0)]
    kfs = []
    for c in centers:
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = -np.asarray(c, np.float32)
        kfs.append(jm.add_keyframe(ff, T, 0.0, 0))
    for i in range(60):
        p = np.array([rng.uniform(-2.2, 3.6), rng.uniform(-3.2, 1.2),
                      rng.uniform(0, 3)], np.float32)
        pid = jm.add_point(p, kfs[i % 3], ff.desc[0])
        for k in range(len(kfs)):
            if rng.random() < 0.6:
                jm.add_observation(pid, kfs[k], i % n)
    m = convert.map_store_from_jax(jm)
    got, want = tmp_path / "got.pgm", tmp_path / "want.pgm"
    gridmap.save_grid_map_tum(m, str(got))
    jgridmap.save_grid_map_tum(jm, str(want))
    text = got.read_text()
    assert text == want.read_text()
    lines = text.splitlines()
    assert lines[:3] == ["P2", "450 300", "255"] and len(lines) == 303
    assert any(v not in ("230",) for v in " ".join(lines[3:]).split())

    sys_ = System(convert.settings_from_jax(make_settings()), Sensor.STEREO,
                  device="cpu")
    sys_.store = m
    via_system = tmp_path / "system.pgm"
    sys_.save_grid_map_tum(str(via_system))
    assert via_system.read_text() == text


def test_pgm_roundtrip(tmp_path):
    g = np.array([[0, 128], [255, 128]], np.uint8)
    p = tmp_path / "g.pgm"
    gridmap.save_pgm(g, str(p))
    txt = open(p).read().split()
    assert txt[:3] == ["P2", "2", "2"]
    assert list(map(int, txt[4:])) == [0, 128, 255, 128]


# ---------------------------------------------------------------------------
# MapStream: the Monopub -> Monosub contract
# ---------------------------------------------------------------------------
def stub_system(store):
    return types.SimpleNamespace(
        store=store,
        local_mapper=types.SimpleNamespace(on_keyframe=[]),
        loop_closer=types.SimpleNamespace(on_loop=[]))


def test_map_stream_payloads_and_full_map_republish():
    m = random_map(seed=4, n_kf=5)
    sys_ = stub_system(m)
    s = stream.MapStream(sys_, all_pts_gap=2)
    assert sys_.local_mapper.on_keyframe == [s._on_keyframe]
    assert sys_.loop_closer.on_loop == [s._on_loop]
    kf_seen, maps_seen = [], []
    s.kf_subscribers.append(lambda *p: kf_seen.append(p))
    s.map_subscribers.append(maps_seen.append)
    for kf in (0, 1, 2):
        sys_.local_mapper.on_keyframe[0](kf)
    assert [p[0] for p in kf_seen] == [0, 1, 2]
    kf, centre, points = kf_seen[1]
    np.testing.assert_array_equal(centre, m.camera_center(1))
    row = m.kf_obs[1]
    pids = row[row >= 0]
    np.testing.assert_array_equal(points, m.pt_pos[pids[m.pt_valid[pids]]])
    assert len(maps_seen) == 1            # after the 2nd keyframe
    assert [p[0] for p in maps_seen[0]] == list(m.valid_kf_ids())
    sys_.loop_closer.on_loop[0](2)        # a loop republishes everything
    assert len(maps_seen) == 2


def test_attach_grid_mapper_follows_keyframes_and_loops():
    m = random_map(seed=9, n_kf=4)
    sys_ = stub_system(m)
    p = gridmap.GridParams(scale_factor=4.0, cloud_min_x=-10,
                           cloud_max_x=10, cloud_min_z=-10, cloud_max_z=10)
    mapper, _ = stream.attach_grid_mapper(sys_, p, all_pts_gap=0)
    ref = gridmap.GridMapper(m, p)
    for kf in (0, 1):
        sys_.local_mapper.on_keyframe[0](kf)
        ref.update_keyframe(kf)
    np.testing.assert_array_equal(mapper.visited, ref.visited)
    # a loop rebuilds from every live keyframe
    m.pt_pos[:10] += 1.0
    sys_.loop_closer.on_loop[0](3)
    ref.rebuild()
    np.testing.assert_array_equal(mapper.visited, ref.visited)
    np.testing.assert_array_equal(mapper.occupied, ref.occupied)


# ---------------------------------------------------------------------------
# System.change_calibration (tests/test_system_e2e.py::TestChangeCalibration)
# ---------------------------------------------------------------------------
def test_hot_swap_rebuilds_steps_and_keeps_tracking(tmp_path):
    """ref: Tracking::ChangeCalibration (src/Tracking.cc:1553-1584): the
    camera-dependent step must be dropped and tracking must survive on the
    live map."""
    settings = convert.settings_from_jax(make_settings())
    scene = CylinderScene(settings.K, H, W)
    probe = circle_trajectory(12, orbit_r=2.0, total_angle=2 * np.pi)
    descs = []
    for Tp in probe:
        f = convert.features_to_numpy(frontend.extract(
            torch.from_numpy(scene.render(Tp)), n_features=600))
        descs.append(f["desc"][f["valid"]])
    voc = Vocabulary.train(np.concatenate(descs), k=10, L=3, levels_up=1)
    sys_ = System(settings, Sensor.STEREO, vocabulary=voc, device="cpu")
    poses = circle_trajectory(10, orbit_r=2.0, total_angle=0.5)
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -BASELINE
    for i, Tp in enumerate(poses[:6]):
        sys_.track_stereo(scene.render(Tp), scene.render(Trl @ Tp), i * 0.2)
    assert sys_.tracker.state.name == "OK"
    old_step = sys_.tracker._fast_step

    yaml = tmp_path / "recal.yaml"
    yaml.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {FX * 1.001}\nCamera.fy: {FY}\n"
        f"Camera.cx: {W / 2}\nCamera.cy: {H / 2}\n"
        f"Camera.bf: {FX * BASELINE * 1.001}\n"
    )
    sys_.change_calibration(str(yaml))
    assert abs(sys_.settings.fx - FX * 1.001) < 1e-6
    assert abs(sys_.settings.bf - FX * BASELINE * 1.001) < 1e-6
    assert sys_.tracker._fast_step is None or \
        sys_.tracker._fast_step is not old_step
    assert float(sys_.builder.intr.fx) == pytest.approx(FX * 1.001)

    for j, Tp in enumerate(poses[6:]):
        sys_.track_stereo(scene.render(Tp), scene.render(Trl @ Tp),
                          2.0 + j * 0.2)
    assert sys_.tracker.state.name == "OK"
