"""The frozen loop-closing references (reference/sim3.py,
reference/pose_graph.py) against the port's solvers on seeded problems at
a small size, and their bfloat16 controls missing by more than each
tolerance.

Sim3: a known Sim3 seen through KITTI's camera, 120 matches at 5-12 m,
pixel noise of one sigma of each level, 10% of the matches moved by up
to 40 px, the points themselves off by 1 cm, the start 0.01 rad and 3 cm
from the truth; stereo (scale held) and mono (scale free, 1.3).

Ring: 16 keyframes on a 3 m circle, each joined to the next two, every
measurement exact, the start 0.03 rad and 0.1 m off, the first keyframe
fixed.  Such a graph has one optimum of zero cost, which ORB-SLAM2's
edge error, log(Sji Si Sj^-1), and the port's, log(Sji^-1 Sj Si^-1),
share, with the scale free or held: there the two solvers must agree.
(Where a loop leaves the graph inconsistent they part: harness/loops.py
measures that on the card, PERF.md.)"""

import numpy as np
import pytest
import torch

from reference import pose_graph as ref_graph
from reference import sim3 as ref_sim3

CAM = (718.856, 718.856, 607.1928, 185.2157)

# port (float32, 5 + 5 Gauss-Newton rounds) against the reference (float64,
# ORB-SLAM2's 5 + 10 LM iterations after a drop): float32 rounding alone
# leaves < 0.001 mm and 6e-6 deg; on a weakly held free scale the port's
# shorter second round leaves up to 0.063 mm and 4e-4 deg (mono, seed 3)
SIM3_TOL = (0.5, 0.005)
# both solves end at the ring's zero-cost optimum: < 0.001 mm and 1.4e-5
# deg seen, float32 rounding of the port's 20 LM steps
RING_TOL = (0.01, 1e-4)


def _rot(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def sim3_problem(seed: int, fix_scale: bool, n: int = 120) -> dict:
    rng = np.random.default_rng(seed)
    s = 1.0 if fix_scale else 1.3
    R, t = _rot(rng.normal(0, 0.3, 3)), rng.normal(0, 0.5, 3)
    pc2 = np.stack([rng.uniform(-4, 4, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(5, 12, n)], 1)
    pc1 = s * pc2 @ R.T + t

    def proj(p):
        return np.stack([CAM[0] * p[:, 0] / p[:, 2] + CAM[2],
                         CAM[1] * p[:, 1] / p[:, 2] + CAM[3]], 1)

    sig2 = 1.2 ** (2 * np.arange(8))
    o1, o2 = rng.integers(0, 4, n), rng.integers(0, 4, n)
    uv1 = proj(pc1) + rng.normal(0, 1, (n, 2)) * np.sqrt(sig2[o1])[:, None]
    uv2 = proj(pc2) + rng.normal(0, 1, (n, 2)) * np.sqrt(sig2[o2])[:, None]
    moved = rng.random(n) < 0.1
    uv1[moved] += rng.uniform(-40, 40, (moved.sum(), 2))
    pc1 = pc1 + rng.normal(0, 0.01, (n, 3))
    pc2 = pc2 + rng.normal(0, 0.01, (n, 3))
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"pts1": f(pc1), "pts2": f(pc2), "uv1": f(uv1), "uv2": f(uv2),
            "inv_sigma2_1": f(1 / sig2[o1]), "inv_sigma2_2": f(1 / sig2[o2]),
            "mask": np.ones(n, bool),
            "R12": f(R @ _rot(rng.normal(0, 0.01, 3))),
            "t12": f(t + rng.normal(0, 0.03, 3)),
            "s12": float(s * (1.0 if fix_scale else 1.02))}


def _ref_sim3(p, fix_scale, dtype):
    return ref_sim3.optimize_sim3(
        p["pts1"], p["pts2"], p["uv1"], p["uv2"], p["inv_sigma2_1"],
        p["inv_sigma2_2"], p["mask"], p["R12"], p["t12"], p["s12"], CAM,
        fix_scale, dtype=dtype)


@pytest.fixture(scope="module", params=[(seed, fix) for fix in (True, False)
                                        for seed in (1, 2, 3)],
                ids=lambda p: f"seed{p[0]}-{'stereo' if p[1] else 'mono'}")
def sim3_solves(request):
    from orb_slam2_tpu_torch.solvers import sim3_solver

    torch.set_num_threads(2)
    seed, fix = request.param
    p = sim3_problem(seed, fix)
    T = torch.as_tensor
    port = sim3_solver.refine_sim3(
        T(p["pts1"]), T(p["pts2"]), T(p["uv1"]), T(p["uv2"]),
        T(p["inv_sigma2_1"]), T(p["inv_sigma2_2"]), T(p["mask"]),
        T(p["R12"]), T(p["t12"]), T(np.float32(p["s12"])), *CAM,
        fix_scale=fix)
    port = [x.double().numpy() for x in port]
    return (port, _ref_sim3(p, fix, torch.float64),
            _ref_sim3(p, fix, torch.bfloat16))


def test_sim3_reference_agrees_with_the_port(sim3_solves):
    port, ref, _ = sim3_solves
    mm, deg = ref_sim3.gap(port[0], port[1], float(port[2]), ref.R, ref.t,
                           ref.s)
    assert ref.ok and mm <= SIM3_TOL[0] and deg <= SIM3_TOL[1], (mm, deg)
    # the same matches come out as inliers
    np.testing.assert_array_equal(port[3], ref.inliers)


def test_sim3_bfloat16_control_misses(sim3_solves):
    _, ref, low = sim3_solves
    mm, deg = ref_sim3.gap(low.R, low.t, low.s, ref.R, ref.t, ref.s)
    assert mm > SIM3_TOL[0] or deg > SIM3_TOL[1], (mm, deg)


def ring_problem(seed: int, K: int = 16) -> dict:
    rng = np.random.default_rng(seed)
    Rs, ts = [], []
    for k in range(K):
        Rwc = _rot(np.array([0.0, 2 * np.pi * k / K + 1e-12, 0.0]))
        C = 3.0 * Rwc[:, 2] + rng.normal(0, 0.05, 3)
        R = Rwc.T @ _rot(rng.normal(0, 0.02, 3))
        Rs.append(R)
        ts.append(-R @ C)
    Rs, ts = np.array(Rs), np.array(ts)
    ei = np.repeat(np.arange(K), 2)
    ej = (ei + np.tile([1, 2], K)) % K
    mR = Rs[ej] @ np.swapaxes(Rs[ei], 1, 2)
    mt = ts[ej] - np.einsum("eij,ej->ei", mR, ts[ei])
    R0 = np.array([R @ _rot(rng.normal(0, 0.03, 3)) for R in Rs])
    t0 = ts + rng.normal(0, 0.1, (K, 3))
    R0[0], t0[0] = Rs[0], ts[0]
    fixed = np.zeros(K, bool)
    fixed[0] = True
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    E = len(ei)
    return {"R": f(R0), "t": f(t0), "s": np.ones(K, np.float32),
            "fixed": fixed, "vmask": np.ones(K, bool), "edge_i": ei,
            "edge_j": ej, "meas_R": f(mR), "meas_t": f(mt),
            "meas_s": np.ones(E, np.float32), "emask": np.ones(E, bool)}


FIELDS = ("R", "t", "s", "fixed", "vmask", "edge_i", "edge_j", "meas_R",
          "meas_t", "meas_s", "emask")


@pytest.fixture(scope="module", params=[(seed, fix) for fix in (True, False)
                                        for seed in (1, 2, 3)],
                ids=lambda p: f"seed{p[0]}-{'held' if p[1] else 'free'}")
def ring_solves(request):
    from orb_slam2_tpu_torch.solvers import pose_graph

    torch.set_num_threads(2)
    seed, fix = request.param
    p = ring_problem(seed)
    prob = pose_graph.PoseGraphProblem(*(torch.as_tensor(p[f])
                                         for f in FIELDS))
    port = tuple(x.double().numpy() for x in pose_graph.optimize(prob))
    args = [p[f] for f in FIELDS]
    return (port, ref_graph.optimize(*args, fix_scale=fix),
            ref_graph.optimize(*args, fix_scale=fix, dtype=torch.bfloat16),
            fix)


def _widest(a, b):
    mm, deg = ref_sim3.gap(*ref_graph.se3_of(*a), *ref_graph.se3_of(*b))
    return float(mm.max()), float(deg.max())


def test_ring_reference_agrees_with_the_port(ring_solves):
    port, ref, _, fix = ring_solves
    mm, deg = _widest(port, ref)
    assert mm <= RING_TOL[0] and deg <= RING_TOL[1], (mm, deg)
    if fix:            # a held scale is exactly 1 (VertexSim3Expmap)
        assert (ref[2] == 1.0).all()


def test_ring_bfloat16_control_misses(ring_solves):
    _, ref, low, _ = ring_solves
    mm, deg = _widest(low, ref)
    assert mm > RING_TOL[0] or deg > RING_TOL[1], (mm, deg)


def test_sim3_exp_and_log_are_inverse_and_match_rodrigues():
    rng = np.random.default_rng(0)
    xi = torch.as_tensor(rng.normal(0, 0.4, (20, 7)))
    back = ref_sim3.log(ref_sim3.exp(xi))
    torch.testing.assert_close(back, xi, rtol=0, atol=1e-12)
    R, _, s = ref_sim3.exp(xi)
    for w, Rk in zip(xi[:, :3].numpy(), R.numpy()):
        np.testing.assert_allclose(Rk, _rot(w), rtol=0, atol=1e-13)
    torch.testing.assert_close(s, torch.exp(xi[:, 6]))
