"""bench_torch.py, the port's bench, held against bench.py on the CPU with
bench.py unchanged: its helpers and output keys read out of bench.py's
source (tests/bench_reference.py), and its pass code driving the JAX
System and the port's System over the same frames."""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from bench_reference import reference_helpers, reference_keys  # noqa: E402
from orb_slam2_tpu.config import Sensor as JSensor  # noqa: E402
from orb_slam2_tpu.system import System as JSystem  # noqa: E402
from orb_slam2_tpu_torch import convert  # noqa: E402
from orb_slam2_tpu_torch.config import Sensor  # noqa: E402
from orb_slam2_tpu_torch.system import System  # noqa: E402
from synthetic import (  # noqa: E402
    PlaneScene, circle_trajectory, stereo_sequence, straight_trajectory,
)
from test_golden import BASELINE, H, W, _settings  # noqa: E402

torch.set_num_threads(2)

REF = reference_helpers()
MAX_ATE_DEV_M = 5e-3
N_PASS_FRAMES = 30


class _Store:
    """The three things kf_ate reads of a map."""

    def __init__(self, ts, poses):
        self.kf_timestamp = np.asarray(ts, np.float64)
        self.kf_pose = np.asarray(poses, np.float32)

    def valid_kf_ids(self):
        return np.arange(len(self.kf_timestamp))


class _System:
    def __init__(self, store):
        self.map = store


def _random_pose(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)]])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(scale=2.0, size=3)
    return T


@pytest.mark.parametrize("mono_scale", [False, True])
@pytest.mark.parametrize("n_kf,past_end", [(12, 0), (12, 4), (3, 1), (2, 0),
                                           (0, 0)])
def test_kf_ate_equals_bench_py(mono_scale, n_kf, past_end):
    """Keyframes at seeded frames (some past the end of gt_poses, which
    both skip), poses seeded; fewer than 3 left gives inf in both."""
    rng = np.random.default_rng(100 * n_kf + past_end)
    gt = circle_trajectory(40, orbit_r=3.0, total_angle=2 * np.pi)
    frames = np.sort(rng.choice(40, n_kf - past_end, replace=False))
    frames = np.concatenate([frames, 40 + np.arange(past_end)])
    ts = frames * 0.1 + rng.uniform(-0.02, 0.02, len(frames))
    s = _System(_Store(ts, [_random_pose(rng) for _ in frames]))
    want = REF["kf_ate"](s, gt, mono_scale=mono_scale)
    got = bench_torch.kf_ate(s, gt, mono_scale=mono_scale)
    if n_kf - past_end < 3:
        assert want == got == float("inf")
    else:
        assert np.isfinite(want) and abs(got - want) <= 1e-12, (got, want)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 11, 240])
def test_quantiles_and_worst_at_equal_bench_py(n):
    xs = list(np.random.default_rng(n).exponential(0.05, n))
    for skip in (0, 3):
        assert bench_torch.quantiles(xs, skip) == REF["quantiles"](xs, skip)
        assert bench_torch.worst_at(xs, skip) == REF["worst_at"](xs, skip)
    assert bench_torch.quantiles(xs) == REF["quantiles"](xs)
    assert bench_torch.worst_at(xs) == REF["worst_at"](xs)


def test_report_has_exactly_bench_py_keys():
    rng = np.random.default_rng(0)
    stats = {"n_keyframes": 9, "loops_closed": 1, "max_queue": 2,
             "n_resets": 0, "relocalizations": 1, "kf_ate_m": 0.05,
             "mapper_ms_per_kf": 120.0}
    results = {name: (list(rng.uniform(0.01, 0.05, 20)),
                      list(rng.uniform(0.05, 0.1, 18)), dict(stats), ok)
               for name, ok in (("mono", True), ("rgbd", True),
                                ("unpipelined", False), ("pipelined", True),
                                ("kidnap", False))}
    out = bench_torch.report(results, 20, 12.3, "card, 700.00 W")
    assert set(out) == reference_keys()
    assert out["degraded_passes"] == ["unpipelined", "kidnap"]
    assert out["unit"].endswith("[card, 700.00 W]")
    assert out["vs_baseline"] == round(out["value"] / 30.0, 3)


def _keyframe_frames(system):
    st = system.map
    return [int(round(t / 0.1)) for t in st.kf_timestamp[: st.n_kf]]


@pytest.mark.parametrize("mode", ["stereo", "rgbd"])
def test_pass_matches_the_jax_system(mode):
    """run_pass over 30 frames drives the JAX System and the port's alike
    (the sync scheduler, for determinism; fps raised so pacing costs
    nothing): keyframes on the same frames, keyframe ATE within 5 mm,
    equal health and counters."""
    js = _settings()
    js.fps = 1e6
    poses = straight_trajectory(N_PASS_FRAMES, step=0.05, yaw_step=0.02)
    if mode == "stereo":
        _, frames = stereo_sequence(js.K, H, W, BASELINE, poses)
    else:
        scene = PlaneScene(js.K, H, W)
        frames = [(scene.render(T), scene.depth_at(T)) for T in poses]
    track = f"track_{mode}"
    ps = convert.settings_from_jax(js)
    kept = {}

    def factory(name, make):
        def build(pipelined):
            kept[name] = make(pipelined)
            return kept[name]
        return build

    def jax_system(pipelined):
        s = copy.copy(js)
        s.pipelined = pipelined
        return JSystem(s, getattr(JSensor, mode.upper()), scheduler="sync")

    def port_system(pipelined):
        s = copy.copy(ps)
        s.pipelined = pipelined
        return System(s, getattr(Sensor, mode.upper()), scheduler="sync",
                      device="cpu")

    runs = {}
    for name, make in (("jax", jax_system), ("port", port_system)):
        runs[name] = bench_torch.run_pass(
            factory(name, make), track, frames, poses, pipelined=False,
            kidnap=False, kidnap_at=N_PASS_FRAMES, precompile=False)
    (jt, jl, jstats, jok), (pt, pl, pstats, pok) = runs["jax"], runs["port"]
    assert len(pt) == len(jt) == N_PASS_FRAMES
    assert len(pl) == len(jl) == N_PASS_FRAMES
    kfs = _keyframe_frames(kept["port"])
    assert len(kfs) >= 4 and kfs == _keyframe_frames(kept["jax"]), kfs
    ate = [bench_torch.kf_ate(kept[n], poses) for n in ("port", "jax")]
    assert abs(ate[0] - ate[1]) <= MAX_ATE_DEV_M, ate
    assert pok == jok is True
    for key in ("n_keyframes", "n_resets", "relocalizations",
                "loops_closed"):
        assert pstats[key] == jstats[key], key
    # on the CPU the port runs the plain path: no graph, no kernel
    window = pstats["window"]
    assert window["captures"] == {"fast_step": 0, "chain_step": 0,
                                  "chain_log": []}
    assert window["launches"] == {"fast": 0, "orb": 0, "stereo": 0}


def test_refuses_without_cuda_before_any_work(monkeypatch):
    """Without a card and without --device cpu the bench exits non-zero
    before it renders or trains anything, and prints no result."""
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "torch.cuda.is_available() is false" in proc.stderr

    def forbidden(*a, **k):
        raise AssertionError("work before the refusal")

    monkeypatch.setattr(bench_torch, "make_circuit", forbidden)
    monkeypatch.setattr(bench_torch, "train_vocabulary", forbidden)
    with pytest.raises(SystemExit) as e:
        bench_torch.main([])
    assert e.value.code != 0
