"""The port's viewers on the CPU: tests/test_viewer.py's live-viewer cases
and tests/test_ar.py's plane-fit, plane-pose and cube cases on the port's
System and modules, plus what the port adds:

- `fit_plane` against the JAX package's on the same points, masks,
  tolerances and samples: the same `ok` and inlier count, inlier masks
  equal, normals within 1e-5 after sign alignment and `d` within 1e-5
  (first-maximum ties, degenerate triples and a NaN point included);
- the menu's localization and reset requests applied by the tracking
  thread, never the viewer's, also while an async pipelined System tracks;
- the render loop's error count is 0 after the HTTP tests;
- `System(use_viewer=True)` raises ImportError naming cv2 without OpenCV;
- `ARViewer` through the port's System anchors the plane the JAX
  package's does on the same frames.
"""

import json
import sys
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.viz import ar as jar
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.config import Sensor
from orb_slam2_tpu_torch.system import System
from orb_slam2_tpu_torch.viz import ar
from synthetic import PlaneScene, stereo_sequence, straight_trajectory
import test_ar
from test_viewer import BASE, H, W, _settings

torch.set_num_threads(2)

NORMAL_ATOL = 1e-5


def _port_settings():
    return convert.settings_from_jax(_settings())


def _tracked(**kw):
    """test_viewer's 6 frames through the port's stereo System."""
    settings = _port_settings()
    poses = straight_trajectory(6, step=0.03, yaw_step=0.002)
    _, pairs = stereo_sequence(settings.K, H, W, BASE, poses)
    sys_ = System(settings, Sensor.STEREO, device="cpu", **kw)
    for i, (l, r) in enumerate(pairs):
        sys_.track_stereo(l, r, i * 0.1)
    sys_.test_pairs = pairs
    return sys_


@pytest.fixture(scope="module")
def tracked_system():
    sys_ = _tracked(use_viewer=True, viewer_port=0)
    yield sys_
    sys_.shutdown()


def _get(port, path, timeout=5.0):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait(cond, what, limit=5.0):
    deadline = time.time() + limit
    while not cond():
        assert time.time() < deadline, what
        time.sleep(0.02)


class TestLiveViewer:
    def test_map_render_draws_content(self, tracked_system):
        from orb_slam2_tpu_torch.viz.live import MapRenderer

        img = MapRenderer(tracked_system).render()
        assert img.shape == (768, 1024, 3)
        # points + frusta must have been drawn over the white canvas
        assert (img < 250).any(axis=2).sum() > 100

    def test_follow_camera_centers_current_pose(self, tracked_system):
        from orb_slam2_tpu_torch.viz.live import MapRenderer

        r = MapRenderer(tracked_system)
        follow = r.render(follow=True)
        # green current-camera frustum visible near image center
        g = (follow[:, :, 1].astype(int) - follow[:, :, 0] > 60)
        ys, xs = np.nonzero(g)
        assert len(xs) > 0
        assert abs(xs.mean() - 512) < 200 and abs(ys.mean() - 389) < 200

    def test_http_state_and_streams(self, tracked_system):
        port = tracked_system.viewer.port
        status, body = _get(port, "/state")
        assert status == 200
        st = json.loads(body)
        assert st["menu"]["follow_camera"] is True
        assert st["state"] == "OK"
        # wait for the render loop to publish a frame
        deadline = time.time() + 5.0
        while time.time() < deadline:
            status, jpg = _get(port, "/map.jpg")
            if len(jpg) > 0:
                break
            time.sleep(0.05)
        assert status == 200 and jpg[:2] == b"\xff\xd8"   # JPEG SOI
        _wait(lambda: _get(port, "/frame.jpg")[1][:2] == b"\xff\xd8",
              "no frame overlay published")
        status, page = _get(port, "/")
        assert status == 200 and b"orb_slam2_tpu_torch viewer" in page

    def test_http_menu_toggle_applies(self, tracked_system):
        """The menu's toggle becomes a request, which the next
        track_stereo applies on the caller's thread (never the viewer's)."""
        sys_ = tracked_system
        port = sys_.viewer.port
        l, r = sys_.test_pairs[-1]
        applied = []
        orig = sys_.tracker.set_localization_mode

        def record(on):
            applied.append((on, threading.get_ident()))
            orig(on)

        sys_.tracker.set_localization_mode = record
        try:
            for k, on in enumerate((True, False)):
                _get(port, f"/menu?localization_mode={int(on)}")
                _wait(lambda: sys_._mode_request is on,
                      "the viewer never asked for the mode")
                assert sys_.tracker.only_tracking is not on  # not yet
                sys_.track_stereo(l, r, 1.0 + 0.1 * k)
                assert sys_.tracker.only_tracking is on
                assert sys_._mode_request is None
        finally:
            del sys_.tracker.set_localization_mode
        assert applied == [(True, threading.get_ident()),
                           (False, threading.get_ident())]
        # the menu's changes make requests, not its level: a caller's own
        # switch survives the viewer's next renders
        sys_.activate_localization_mode()
        n = sys_.viewer.renders
        _wait(lambda: sys_.viewer.renders >= n + 2, "no render")
        sys_.track_stereo(l, r, 1.2)
        assert sys_.tracker.only_tracking and sys_._mode_request is None
        sys_.deactivate_localization_mode()
        status, _ = _get(port, "/menu?bogus=1")
        assert status == 404

    def test_render_loop_raised_nothing(self, tracked_system):
        v = tracked_system.viewer
        _wait(lambda: v.renders >= 3, "the render loop is not running")
        assert v.render_errors == 0, v.last_render_error
        assert v.thread.is_alive()


def test_orbit_camera(tracked_system):
    """Free-orbit navigation (Pangolin non-follow parity): /view deltas
    rotate/zoom/pan the non-follow camera and change the rendered map."""
    from orb_slam2_tpu_torch.viz.live import MapRenderer

    r = MapRenderer(tracked_system)
    base = r.render(follow=False)
    r.orbit_update(daz=1.2, delv=0.2)
    turned = r.render(follow=False)
    assert (base != turned).any(), "orbit rotation changed nothing"
    r.orbit_update(dr=0.5)
    zoomed = r.render(follow=False)
    assert (turned != zoomed).any(), "orbit zoom changed nothing"
    az0 = r.orbit["az"]
    r.orbit_update(dx=0.1, dy=-0.05)
    assert r.orbit["az"] == az0
    assert np.linalg.norm(r.orbit_target) > 0


def test_frame_drawer_and_headless_viewer(tracked_system, tmp_path):
    """FrameDrawer's overlay and status bar; the headless Viewer writes the
    overlay and the matplotlib map figure every `period` updates."""
    from orb_slam2_tpu_torch.viz.viewer import FrameDrawer, Viewer

    l, _ = tracked_system.test_pairs[-1]
    out = FrameDrawer(tracked_system).draw(l)
    assert out.shape == (H + 20, W, 3)
    assert (out[:H, :, 1] > out[:H, :, 0]).sum() > 50   # green map points
    v = Viewer(tracked_system, out_dir=str(tmp_path), period=2)
    v.update(l)
    v.update(l)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "frame_000002.png", "map_000002.png"]


def test_ar_viewer_matches_jax_and_finds_the_scene_plane():
    """ARViewer through the port's System against the JAX package's
    ARViewer through the JAX System on the same 6 frames (both seeded the
    same): the anchored plane's normal and offset within 1e-4.  Against
    the rendered plane (the world frame is the first camera's) only what
    this 240x320 map allows: at ~9 px of disparity both packages' maps lie
    ~4% nearer than PlaneScene's d = 3 m and tilt by ~2.6 deg, so cos >=
    0.995 and the offset within 5% (`chip_smoke.py` phase 11b holds the
    KITTI-shaped run to 0.999 and 2%).  Then the cube is drawn.  A System
    of its own: the viewer's tests switch modes and track more frames."""
    from orb_slam2_tpu.config import Sensor as JSensor
    from orb_slam2_tpu.system import System as JSystem

    port = _tracked()
    jsys = JSystem(_settings(), JSensor.STEREO)
    for i, (l, r) in enumerate(port.test_pairs):
        jsys.track_stereo(l, r, i * 0.1)
    v, jv = ar.ARViewer(port), jar.ARViewer(jsys)
    assert v.detect_plane() and jv.detect_plane()

    def plane(Tpw):
        n = Tpw[:3, 2].astype(np.float64)
        return n, float(np.dot(n, Tpw[:3, 3]))

    (n, offset), (jn, joffset) = plane(v.Tpw), plane(jv.Tpw)
    np.testing.assert_allclose(n, jn, rtol=0, atol=1e-4)
    assert abs(offset - joffset) <= 1e-4
    scene = PlaneScene(port.settings.K, H, W)
    assert abs(np.dot(n, scene.n)) >= 0.995
    assert abs(abs(offset) - scene.d) <= 0.05 * scene.d, offset
    l, _ = port.test_pairs[-1]
    img = v.draw(l)
    assert img.shape == (H, W, 3) and (img[:, :, 2] == 255).any()


def test_viewer_without_opencv_raises_at_construction(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        System(_port_settings(), Sensor.STEREO, use_viewer=True,
               viewer_port=None, device="cpu")


def _check_store_invariants(store):
    with store.lock:
        kfs = store.valid_kf_ids()
        assert np.isfinite(store.kf_pose[kfs]).all()
        rows = store.kf_obs[kfs]
        assert (rows[rows >= 0] < store.n_pt).all()
        pids = store.valid_pt_ids()
        assert np.isfinite(store.pt_pos[pids]).all()
        idx, okfs, ofeats = store.obs.dump(pids)
        assert (store.kf_obs[okfs, ofeats] == pids[idx]).all()


def test_menu_requests_apply_on_the_tracking_thread_async_pipelined():
    """The async pipelined System with the viewer (no HTTP server): the
    menu's localization toggle and Reset are applied by track_stereo on
    the caller's thread, after the frames in flight are drained; the
    mapping worker never fails, the store keeps its invariants, and
    tracking starts a new map after the reset."""
    from test_golden import BASELINE as GB
    from test_golden import H as GH
    from test_golden import W as GW
    from test_golden import _settings as golden_settings

    s = convert.settings_from_jax(golden_settings())
    s.pipelined = True
    poses = straight_trajectory(16, step=0.05, yaw_step=0.02)
    _, pairs = stereo_sequence(s.K, GH, GW, GB, poses)
    sys_ = System(s, Sensor.STEREO, scheduler="async", use_viewer=True,
                  viewer_port=None, device="cpu")
    assert sys_.tracker.pipelined
    calls = []
    mode_orig, reset_orig = sys_.tracker.set_localization_mode, sys_.reset

    def mode(on):
        calls.append(("mode", on, threading.get_ident(),
                      len(sys_.tracker._pending)))
        mode_orig(on)

    def reset():
        calls.append(("reset", None, threading.get_ident(),
                      len(sys_.tracker._pending)))
        reset_orig()

    sys_.tracker.set_localization_mode = mode
    sys_.reset = reset
    v = sys_.viewer
    try:
        for i, (l, r) in enumerate(pairs):
            if i == 5:
                v.set_menu("localization_mode", True)
                _wait(lambda: sys_._mode_request is True,
                      "no mode request")
            if i == 8:
                v.set_menu("localization_mode", False)
                _wait(lambda: sys_._mode_request is False,
                      "no mode request")
            if i == 10:
                v.set_menu("reset", True)
                _wait(lambda: sys_._reset_request, "no reset request")
                assert v.menu["reset"] is False
            sys_.track_stereo(l, r, i * 0.1)
            if i in (5, 8):
                assert sys_.tracker.only_tracking is (i == 5)
            sys_.poll()
        sys_.drain()
        assert [c[:2] for c in calls] == [("mode", True), ("mode", False),
                                          ("reset", None)]
        me = threading.get_ident()
        assert all(c[2] == me for c in calls)
        assert all(c[3] == 0 for c in calls), "applied with frames in flight"
        assert sys_.tracker.resets == 1 and sys_.stats()["resets"] == 1
        assert sys_.store is sys_.tracker.store is sys_.local_mapper.store
        sys_._raise_worker_error()
        assert sys_.tracker.state.name == "OK"
        _wait(sys_.local_mapper.idle, "the mapper never quiesced", 60.0)
        _check_store_invariants(sys_.store)
        assert int(sys_.store.kf_valid.sum()) >= 1
        assert v.render_errors == 0, v.last_render_error
    finally:
        sys_.shutdown()
    assert not v.thread.is_alive()
    assert all(not w.is_alive() for w in sys_._workers)


# ---------------------------------------------------------------------------
# the AR module: tests/test_ar.py on the port, and fit_plane against JAX
# ---------------------------------------------------------------------------

_cloud = test_ar.TestFitPlane._cloud


def _fit_both(pts, mask, tol, samples):
    j = jar.fit_plane(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(tol),
                      jnp.asarray(samples))
    t = ar.fit_plane(torch.from_numpy(pts), torch.from_numpy(mask),
                     torch.from_numpy(tol), torch.from_numpy(samples))
    return j, t


def _assert_same_fit(j, t):
    assert bool(t.ok) == bool(j.ok)
    assert int(t.n_inliers) == int(j.n_inliers)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert t.n_inliers.dtype == torch.int32
    nj, dj = np.asarray(j.normal), float(j.d)
    nt, dt = t.normal.numpy(), float(t.d)
    if np.dot(nt, nj) < 0:       # the same plane, the other orientation
        nt, dt = -nt, -dt
    np.testing.assert_allclose(nt, nj, rtol=0, atol=NORMAL_ATOL)
    assert abs(dt - dj) <= NORMAL_ATOL


class TestFitPlanePort:
    def test_recovers_plane_under_outliers(self):
        rng = np.random.default_rng(3)
        pts, n_true, d_true, n_in = _cloud(None, rng)
        N = len(pts)
        samples = rng.integers(0, N, (100, 3)).astype(np.int32)
        fit = ar.fit_plane(
            torch.from_numpy(pts), torch.ones(N, dtype=torch.bool),
            torch.full((N,), 0.02), torch.from_numpy(samples))
        assert bool(fit.ok)
        n = fit.normal.numpy()
        if np.dot(n, n_true) < 0:
            n, d = -n, -float(fit.d)
        else:
            d = float(fit.d)
        assert abs(np.dot(n, n_true)) > 0.999, n
        assert abs(d - d_true) < 0.02
        assert int(fit.n_inliers) > 0.9 * n_in

    def test_masked_points_ignored(self):
        rng = np.random.default_rng(4)
        pts, n_true, _, n_in = _cloud(None, rng, n_in=60, n_out=0)
        junk = rng.uniform(10, 20, (50, 3)).astype(np.float32)
        allp = np.concatenate([pts, junk])
        mask = np.concatenate([np.ones(len(pts), bool),
                               np.zeros(len(junk), bool)])
        samples = rng.integers(0, len(pts), (80, 3)).astype(np.int32)
        fit = ar.fit_plane(
            torch.from_numpy(allp), torch.from_numpy(mask),
            torch.full((len(allp),), 0.02), torch.from_numpy(samples))
        assert bool(fit.ok)
        assert int(fit.n_inliers) <= len(pts)
        n = fit.normal.numpy()
        assert abs(np.dot(n, n_true)) > 0.995

    @pytest.mark.parametrize("seed,n_in,n_out,S", [
        (3, 120, 40, 100), (5, 1434, 614, 50), (6, 1434, 614, 1024),
        (7, 30, 60, 16)])
    def test_matches_jax(self, seed, n_in, n_out, S):
        rng = np.random.default_rng(seed)
        pts, _, _, _ = _cloud(None, rng, n_in=n_in, n_out=n_out)
        N = len(pts)
        mask = rng.uniform(size=N) > 0.05
        tol = rng.uniform(0.01, 0.03, N).astype(np.float32)
        samples = rng.integers(0, N, (S, 3)).astype(np.int32)
        _assert_same_fit(*_fit_both(pts, mask, tol, samples))

    def test_ties_take_the_first_maximum(self):
        """Two planes with 10 points each: the first triple's plane wins
        in both packages."""
        rng = np.random.default_rng(8)
        xy = rng.uniform(-1, 1, (20, 2))
        a = np.column_stack([xy[:10], np.full(10, 2.0)])       # z = 2
        b = np.column_stack([np.full(10, 1.5), xy[10:]])       # x = 1.5
        pts = np.concatenate([a, b]).astype(np.float32)
        mask = np.ones(20, bool)
        tol = np.full(20, 0.01, np.float32)
        for first, normal in (([10, 11, 12], [1, 0, 0]),
                              ([0, 1, 2], [0, 0, 1])):
            other = [0, 1, 2] if first[0] == 10 else [10, 11, 12]
            samples = np.array([first, other], np.int32)
            j, t = _fit_both(pts, mask, tol, samples)
            _assert_same_fit(j, t)
            assert int(t.n_inliers) == 10
            assert abs(np.dot(t.normal.numpy(), normal)) > 0.999

    def test_degenerate_triples_vote_minus_one(self):
        rng = np.random.default_rng(9)
        pts, _, _, _ = _cloud(None, rng, n_in=40, n_out=0)
        N = len(pts)
        mask, tol = np.ones(N, bool), np.full(N, 0.02, np.float32)
        # every triple repeats a point: no hypothesis, no fit
        rep = rng.integers(0, N, 8)
        samples = np.stack([rep, rep, rng.integers(0, N, 8)], 1).astype(
            np.int32)
        j, t = _fit_both(pts, mask, tol, samples)
        assert not bool(t.ok) and not bool(j.ok)
        # one good triple among degenerate ones wins
        samples[3] = [0, 1, 2]
        _assert_same_fit(*_fit_both(pts, mask, tol, samples))

    def test_a_nan_point_gives_nan_like_jax(self):
        """A masked NaN point makes the scatter matrix NaN: JAX's eigh
        returns NaN, torch's would raise; the port gives NaN too."""
        rng = np.random.default_rng(10)
        pts, _, _, _ = _cloud(None, rng, n_in=40, n_out=0)
        pts[5] = np.nan
        N = len(pts)
        mask = np.ones(N, bool)
        mask[5] = False
        samples = rng.integers(6, N, (20, 3)).astype(np.int32)
        j, t = _fit_both(pts, mask, np.full(N, 0.02, np.float32), samples)
        assert np.isnan(np.asarray(j.normal)).all()
        assert torch.isnan(t.normal).all()
        assert bool(t.ok) == bool(j.ok)
        assert int(t.n_inliers) == int(j.n_inliers) == 0


class TestPlanePose:
    def test_orthonormal_and_oriented(self):
        n = np.array([0.1, -0.9, 0.3])
        n /= np.linalg.norm(n)
        d = -0.7
        cam = np.array([0.0, -3.0, 0.0])
        T = ar.plane_pose(n, d, cam)
        R = T[:3, :3]
        np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-5)
        assert np.linalg.det(R) > 0.99
        o = T[:3, 3]
        z = R[:, 2]
        assert abs(np.dot(z, o) + (d if np.dot(n, cam) + d >= 0
                                   else -d)) < 1e-5
        assert np.dot(z, cam - o) > 0
        np.testing.assert_array_equal(T, jar.plane_pose(n, d, cam))


class TestDrawCube:
    def test_overlay_modifies_image(self):
        img = np.zeros((120, 160), np.uint8)
        K = np.array([[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]])
        Tcw = np.eye(4, dtype=np.float32)
        Tpw = np.eye(4, dtype=np.float32)
        Tpw[:3, 2] = [0, 0, -1]
        Tpw[:3, 0] = [1, 0, 0]
        Tpw[:3, 1] = [0, -1, 0]
        Tpw[:3, 3] = [0, 0, 2.0]
        out = ar.draw_cube(img, Tcw, K, Tpw, size=0.5)
        assert out.shape == (120, 160, 3)
        assert out.sum() > 0
        np.testing.assert_array_equal(
            out, jar.draw_cube(img, Tcw, K, Tpw, size=0.5))
