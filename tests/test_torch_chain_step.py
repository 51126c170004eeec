"""The port's chained (pipelined) tracking step against the JAX package's
`build_track_step_chained` on the same inputs, both on the CPU (JAX on
its XLA path, the port eagerly on its plain PyTorch versions), and the
bookkeeping of the runner that drives it.

A 240x320 CylinderScene sequence at 800 features and 8 levels, in stereo
and rgbd modes: frame 0 is built by the port's FrameBuilder and gives the
map (tests/test_torch_track_blocks.py), which goes into a device-map
mirror as numpy arrays; the anchor `ChainState` is frame 0's fields, its
point ids, the identity pose and the trajectory's constant motion.
Frames 1-3 go through both steps with the SAME chain, mirror and
candidate ids: an anchor frame and two chained frames, the chain
advancing on the JAX step's output.

Tolerances (measured values in each test's docstring): Tcw and the new
chain's T_cur and velocity within 1e-4; point ids and inliers equal on
>= 99% of valid features; the counts among the six diagnostics equal
within 1, |dt| within 1e-3 relative or 2e-5 m (it is the translation of
T2 inv(T_pred), millimetres here, and the two T2 agree to ~5e-6), the
rotation angle
within 1e-3 relative or, as its cosine, within 2.5e-7: both packages take
it as the arccos of a float32 trace, whose steps of 2.4e-7 near 3 are
steps of 1.2e-7 in the cosine, 3.5e-3 deg at the 0.11 deg of these
frames; the pose within 0.05 m / 0.5 deg of the rendered truth.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.config import Settings as JSettings
from orb_slam2_tpu.slam import track_step as jts
from orb_slam2_tpu_torch import convert, utils
from orb_slam2_tpu_torch.slam import track_step as tts
from orb_slam2_tpu_torch.slam.frame import FrameBuilder
from synthetic import CylinderScene, circle_trajectory
from test_torch_track_blocks import pose_error, stereo_init_map

torch.set_num_threads(2)

H, W = 240, 320
FX = 260.0
BASELINE = 0.5
N_FEATURES = 800
CAP = 4096                     # mirror rows
POSE_ATOL = 1e-4
MIN_SAME = 0.99
MAX_ERR_M, MAX_ERR_DEG = 0.05, 0.5
CHAIN_FIELDS = tts.ChainState._fields


def chain_to_numpy(chain) -> dict:
    out = {}
    for k, v in zip(CHAIN_FIELDS, chain):
        a = v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
        out[k] = a.view(np.uint32) if k == "desc" and a.dtype == np.int32 \
            else a
    return out


def run_sequence(mode: str, n_frames: int = 4):
    """Frames 1..n_frames-1 through both chained steps in `mode`: a list
    of dicts with each package's unpacked result, diagnostics and new
    chain, and the truth."""
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]])
    scene = CylinderScene(K, H, W, radius=8.0, tex_h=2048)
    poses = circle_trajectory(240, orbit_r=3.0,
                              total_angle=3 * np.pi)[:n_frames]
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -BASELINE
    js = JSettings(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=BASELINE * FX,
                   width=W, height=H, n_features=N_FEATURES)
    s = convert.settings_from_jax(js)

    def images(T):
        left = scene.render(T).astype(np.uint8)
        if mode == "stereo":
            return left, scene.render(Trl @ T).astype(np.uint8)
        return left, scene.depth_at(T).astype(np.float32)

    builder = FrameBuilder(s, device="cpu")
    l0, r0 = images(poses[0])
    f0 = (builder.stereo_pair(l0, r0, 0.0) if mode == "stereo"
          else builder.rgbd(l0, r0, 0.0)).feats
    pts = stereo_init_map(f0.xy, f0.depth, f0.valid, f0.octave, f0.desc,
                          s.fx, s.fy, s.cx, s.cy, s.scale_factors())
    n_pt = len(pts["pos"])
    assert 300 < n_pt < CAP

    # the mirror: one row a point; a dead point (valid 0) among them
    mir_f32 = np.zeros((CAP, 9), np.float32)
    mir_f32[:n_pt, 0:3] = pts["pos"]
    mir_f32[:n_pt, 3:6] = pts["normal"]
    mir_f32[:n_pt, 6] = pts["min_dist"]
    mir_f32[:n_pt, 7] = pts["max_dist"]
    mir_f32[:n_pt, 8] = 1.0
    mir_f32[5, 8] = 0.0
    mir_desc = np.zeros((CAP, 8), np.uint32)
    mir_desc[:n_pt] = pts["desc"]

    # the anchor: frame 0's features carry every point but the first 40,
    # which only the candidate list offers (so both blocks are at work)
    pid = np.full(f0.n, -1, np.int32)
    pid[pts["feat"]] = np.arange(n_pt)
    pid[pts["feat"][:40]] = -1
    chain = dict(
        xy=f0.xy, ur=f0.ur, octave=f0.octave.astype(np.int32),
        angle=f0.angle, desc=f0.desc, pid=pid,
        T_cur=np.eye(4, dtype=np.float32),
        velocity=(poses[1] @ np.linalg.inv(poses[0])).astype(np.float32))
    M = utils.bucket_size(n_pt)
    cand = np.full(M, -1, np.int32)
    cand[:n_pt] = np.arange(n_pt)
    scal = np.array([3.0 if mode == "rgbd" else 1.0, 0.0], np.float32)

    jstep = jts.build_track_step_chained(js, mode)
    tstep = tts.build_track_step_chained(s, mode, device="cpu")
    t_mir = (torch.from_numpy(mir_f32),
             torch.from_numpy(mir_desc.view(np.int32)))
    out = []
    for k in range(1, n_frames):
        img_l, img_r = images(poses[k])
        jo, jchain = jstep(
            jnp.asarray(img_l), jnp.asarray(img_r),
            jts.ChainState(**{f: jnp.asarray(chain[f])
                              for f in CHAIN_FIELDS}),
            jnp.asarray(mir_f32), jnp.asarray(mir_desc), jnp.asarray(cand),
            jnp.asarray(scal))
        jbuf = np.asarray(jo.f32_pack)
        jres, _ = jts.unpack_track_out(jo, f0.n, M, buf=jbuf)

        to, tchain = tstep(
            torch.from_numpy(img_l), torch.from_numpy(img_r),
            tts.ChainState(**{
                f: torch.from_numpy(np.array(
                    chain[f].view(np.int32) if f == "desc" else chain[f]))
                for f in CHAIN_FIELDS}),
            *t_mir, torch.from_numpy(cand), torch.from_numpy(scal))
        tbuf = to.f32_pack.numpy()
        tres, _ = tts.unpack_track_out(to, f0.n, M, buf=tbuf)
        assert tbuf.shape == jbuf.shape

        out.append(dict(
            j=jres._asdict(), t=tres._asdict(),
            jdiag=jbuf[-jts.N_DIAG:], tdiag=tbuf[-tts.N_DIAG:],
            jchain=chain_to_numpy(jchain), tchain=chain_to_numpy(tchain),
            truth=poses[k] @ np.linalg.inv(poses[0]), in_chain=chain))
        chain = chain_to_numpy(jchain)
    return out


@pytest.fixture(scope="module", params=["stereo", "rgbd"])
def run(request):
    return run_sequence(request.param)


FRAMES = [0, 1, 2]    # the anchor frame and two chained frames


@pytest.mark.parametrize("i", FRAMES)
def test_pose_and_new_chain_match_jax(run, i):
    """Tcw, and the next chain's T_cur and velocity, within 1e-4
    (measured <= 1.2e-6); the chain's feature fields equal the frame's."""
    r = run[i]
    np.testing.assert_allclose(r["t"]["Tcw"], r["j"]["Tcw"], atol=POSE_ATOL,
                               rtol=0)
    for k in ("T_cur", "velocity"):
        np.testing.assert_allclose(r["tchain"][k], r["jchain"][k],
                                   atol=POSE_ATOL, rtol=0)
    for k in ("xy", "octave"):
        np.testing.assert_array_equal(r["tchain"][k], r["jchain"][k])
        np.testing.assert_array_equal(r["tchain"][k], r["t"][k])
    np.testing.assert_array_equal(r["tchain"]["ur"], r["t"]["ur"])
    # a trusted solve: the chain carries it on, not the prediction
    assert r["j"]["n_inliers"] >= 30
    np.testing.assert_array_equal(r["tchain"]["T_cur"], r["t"]["Tcw"])


@pytest.mark.parametrize("i", FRAMES)
def test_point_ids_and_inliers_agree(run, i):
    """Per-feature point ids (not slots) and inliers equal on >= 99% of
    valid features (measured: all), the carried ids of the next chain
    too; vis_local equal; ids come from both blocks."""
    r = run[i]
    j, t = r["j"], r["t"]
    v = j["valid"]
    assert v.sum() > 300
    assert (t["assign"] == j["assign"])[v].mean() >= MIN_SAME
    assert (t["inlier"] == j["inlier"])[v].mean() >= MIN_SAME
    assert (r["tchain"]["pid"] == r["jchain"]["pid"])[v].mean() >= MIN_SAME
    np.testing.assert_array_equal(t["vis_local"], j["vis_local"])
    ids = t["assign"][t["assign"] >= 0]
    assert len(ids) == len(set(ids.tolist())), "a point bound twice"
    carried = set(r["in_chain"]["pid"][r["in_chain"]["pid"] >= 0].tolist())
    assert sum(p in carried for p in ids.tolist()) >= 100
    assert sum(p not in carried for p in ids.tolist()) >= 5
    assert 5 not in ids.tolist(), "the dead mirror row was bound"
    # the next chain carries the inliers' ids only
    np.testing.assert_array_equal(
        r["tchain"]["pid"], np.where(t["inlier"], t["assign"], -1))


@pytest.mark.parametrize("i", FRAMES)
def test_diagnostics_match_jax(run, i):
    """n_th, n_vis, widened and inl1 within 1 (measured: equal); |dt|
    within 1e-3 relative or 2e-5 m (measured <= 5.8e-6 m on 2.2 mm); the
    rotation angle within
    1e-3 relative or two steps of the float32 trace (measured: one)."""
    r = run[i]
    jd, td = r["jdiag"], r["tdiag"]
    assert np.isfinite(td).all()
    for k in (0, 1, 3):
        assert abs(td[k] - jd[k]) <= 1, (k, td, jd)
    assert td[2] == jd[2]
    assert td[1] >= td[0] > 100 and td[3] >= 30
    np.testing.assert_allclose(td[4], jd[4], rtol=1e-3, atol=2e-5)
    cos_t, cos_j = (np.cos(np.radians(np.float64(d[5]))) for d in (td, jd))
    assert (abs(td[5] - jd[5]) <= 1e-3 * jd[5]
            or abs(cos_t - cos_j) <= 2.5e-7), (td[5], jd[5])
    assert abs(r["t"]["n_matches_mm"] - r["j"]["n_matches_mm"]) <= 1
    assert abs(r["t"]["n_inliers"] - r["j"]["n_inliers"]) <= 1


@pytest.mark.parametrize("i", FRAMES)
def test_pose_against_rendered_truth(run, i):
    """Within 0.05 m and 0.5 deg of the rendered pose."""
    dt, dr = pose_error(run[i]["t"]["Tcw"], run[i]["truth"])
    assert dt <= MAX_ERR_M and dr <= MAX_ERR_DEG, (dt, dr)


# ---------------------------------------------------------------------------
# the step's guards, on hand-made chains (port only)
# ---------------------------------------------------------------------------

def _tiny_step_inputs(cap=64, n_cand=128):
    s = convert.settings_from_jax(JSettings(
        fx=FX, fy=FX, cx=64, cy=48, bf=BASELINE * FX, width=128, height=96,
        n_features=200, n_levels=4))
    step = tts.build_track_step_chained(s, "stereo", device="cpu")
    from orb_slam2_tpu_torch.ops.frontend import padded_total
    n = padded_total(s.n_features, s.n_levels, s.scale_factor)
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 255, (96, 128), np.uint8))
    eye = torch.eye(4)
    chain = tts.ChainState(
        xy=torch.zeros(n, 2), ur=torch.full((n,), -1.0),
        octave=torch.zeros(n, dtype=torch.int32), angle=torch.zeros(n),
        desc=torch.zeros(n, 8, dtype=torch.int32),
        pid=torch.full((n,), -1, dtype=torch.int32), T_cur=eye,
        velocity=eye)
    mir = (torch.zeros(cap, 9), torch.zeros(cap, 8, dtype=torch.int32))
    cand = torch.full((n_cand,), -1, dtype=torch.int32)
    return step, img, chain, mir, cand, n


def test_untrusted_solve_keeps_the_prediction_and_drops_the_ids():
    """Fewer than 30 inliers: the next chain is the motion-model
    prediction with the old velocity and no point ids, the pack is finite
    and reports the weak solve."""
    step, img, chain, mir, cand, n = _tiny_step_inputs()
    vel = torch.eye(4)
    vel[2, 3] = -0.1
    chain = chain._replace(velocity=vel)
    out, new = step(img, img, chain, *mir, cand, torch.tensor([1.0, 0.0]))
    buf = out.f32_pack.numpy()
    assert np.isfinite(buf[:18]).all() and np.isfinite(buf[-6:]).all()
    assert buf[17] < 30
    assert bool((new.pid == -1).all())
    torch.testing.assert_close(new.T_cur, vel @ chain.T_cur)
    torch.testing.assert_close(new.velocity, vel)
    assert new.pid.dtype == torch.int32 and new.octave.dtype == torch.int32
    assert buf.shape == (18 + 10 * n + 128 + 8 * n + tts.N_DIAG,)


def test_ids_beyond_the_mirror_are_masked_not_read():
    """A chain or candidate id past the mirror's rows (a point born since
    the mirror last grew) is never visible and never bound: the step
    neither faults nor reads another row under that id."""
    step, img, chain, mir, cand, n = _tiny_step_inputs(cap=64)
    mir[0][:, 8] = 1.0                       # every mirror row alive
    mir[0][:, 2] = 4.0                       # in front of the camera
    mir[0][:, 6], mir[0][:, 7] = 0.1, 100.0
    pid = chain.pid.clone()
    pid[:10] = torch.arange(60, 70, dtype=torch.int32)   # 64.. are beyond
    cand = cand.clone()
    cand[:8] = torch.arange(62, 70, dtype=torch.int32)
    out, new = step(img, img, chain._replace(pid=pid), *mir, cand,
                    torch.tensor([1.0, 0.0]))
    res, _ = tts.unpack_track_out(out, n, 128, buf=out.f32_pack.numpy())
    assert not res.vis_local[2:8].any()      # candidates 64..69
    assert (res.assign < 64).all()
    assert out.f32_pack.numpy()[-5] <= 4     # n_vis: ids 60..63 at most


# ---------------------------------------------------------------------------
# the runner and its staging ring
# ---------------------------------------------------------------------------

def test_slot_ring_never_hands_out_a_held_slot():
    """depth + 2 slots; a held slot is skipped, a released one comes back,
    and when every slot is held the ring grows instead of reusing one."""
    ring = tts.SlotRing(5, pinned=False)
    held = [ring.acquire() for _ in range(5)]
    assert len({id(s) for s in held}) == 5 and ring.held() == 5
    extra = ring.acquire()                   # all held: the ring grows
    assert all(extra is not s for s in held) and len(ring.slots) == 6
    ring.release(held[2])
    assert ring.acquire() is held[2]         # the only free slot
    for s in held + [extra]:
        ring.release(s)
    assert ring.held() == 0
    # in steady state the slots go round in order
    order = []
    for _ in range(12):
        s = ring.acquire()
        order.append(ring.slots.index(s))
        ring.release(s)
    assert sorted(set(order)) == list(range(6))
    assert all((b - a) % 6 == 1 for a, b in zip(order, order[1:]))


def test_slot_buffers_are_per_slot_and_reused():
    ring = tts.SlotRing(2, pinned=False)
    a, b = ring.acquire(), ring.acquire()
    buf_a = a.buf("img_l", (4, 6), torch.uint8)
    assert buf_a is a.buf("img_l", (4, 6), torch.uint8)
    assert buf_a.data_ptr() != b.buf("img_l", (4, 6), torch.uint8).data_ptr()
    assert a.buf("img_l", (8, 6), torch.uint8) is not buf_a   # a new shape
    buf_a.fill_(7)
    b.buf("img_l", (4, 6), torch.uint8).fill_(9)
    assert int(buf_a[0, 0]) == 7             # b's frame did not overwrite a's


class _FakeEvent:
    def __init__(self):
        self.done, self.waited = False, 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True


def test_pending_frame_holds_its_slot_until_read_or_dropped():
    """`is_ready` asks the event and does not wait; `wait` waits once,
    copies the pack out and frees the slot; a dropped frame frees its slot
    unread; the next user of a slot waits for the event behind it."""
    ring = tts.SlotRing(3, pinned=False)
    slot = ring.acquire()
    slot.event = _FakeEvent()
    host = slot.buf("pack", (5,), torch.float32)
    host.copy_(torch.arange(5.0))
    pend = tts.PendingFrame(host, torch.zeros(2), ring, slot)
    assert not pend.is_ready() and slot.event.waited == 0
    assert ring.held() == 1
    buf = pend.wait()
    assert slot.event.waited == 1 and pend.is_ready()
    assert ring.held() == 0
    host.zero_()                              # the slot's next frame
    np.testing.assert_array_equal(buf, np.arange(5.0, dtype=np.float32))
    assert pend.wait() is buf                 # read once

    slot2 = ring.acquire()
    slot2.event = _FakeEvent()
    dropped = tts.PendingFrame(slot2.buf("pack", (5,), torch.float32),
                               torch.zeros(2), ring, slot2)
    dropped.release()
    assert ring.held() == 0 and slot2.event.waited == 0
    # ... and whoever takes that slot next waits for its copies first
    for _ in range(3):
        s = ring.acquire()
        ring.release(s)
    assert slot2.event.waited == 1


def test_chain_runner_on_the_cpu_runs_the_eager_step():
    """On the CPU a dispatch is the eager step: ready at once, the chain
    advances, a re-anchor replaces it, and dispatch before set_chain
    raises."""
    step, img, chain, mir, cand, n = _tiny_step_inputs()
    runner = tts.ChainRunner(step, "cpu", depth=3)
    scal = np.array([1.0, 0.0], np.float32)
    with pytest.raises(RuntimeError, match="set_chain"):
        runner.dispatch(img.numpy(), img.numpy(), *mir, cand.numpy(), scal)
    runner.set_chain(chain)
    assert runner.chain.pid is not chain.pid         # its own copy
    pend = runner.dispatch(img.numpy(), img.numpy(), *mir, cand.numpy(),
                           scal)
    assert pend.is_ready()
    want, want_chain = step(img, img, chain, *mir, cand,
                            torch.from_numpy(scal))
    np.testing.assert_array_equal(pend.wait(), want.f32_pack.numpy())
    assert torch.equal(pend.desc, want.desc)
    assert torch.equal(runner.chain.xy, want_chain.xy)
    assert runner.captures == 0 and runner.ring.held() == 0
    runner.set_chain(chain)
    assert torch.equal(runner.chain.xy, chain.xy)


def test_build_chained_is_memoized_and_needs_a_card_for_cuda():
    s = convert.settings_from_jax(JSettings(
        fx=FX, fy=FX, cx=64, cy=48, bf=BASELINE * FX, width=128, height=96,
        n_features=200, n_levels=4))
    a = tts.build_track_step_chained(s, "stereo", device="cpu")
    assert a is tts.build_track_step_chained(s, True, device="cpu")
    assert a is not tts.build_track_step_chained(s, "rgbd", device="cpu")
    assert a is not tts.build_track_step(s, "stereo", device="cpu")
    assert callable(a) and not isinstance(a, tts.GraphStep)
