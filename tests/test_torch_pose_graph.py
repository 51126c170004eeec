"""The Sim3 pose graph of the port against the JAX package on the CPU, in
dense and cg mode, on the four problems of tests/test_ba.py::
TestPoseGraph (built here by numpy from a seed and fed to both through
`convert.pose_graph_problem_from_numpy`): a noisy drifted loop, exact
measurements, a ring with chords, and scale drift.  Optimised camera
centres must agree within 1e-3 m and scales within 1e-3; each problem
also keeps the JAX test's own bound on the result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from orb_slam2_tpu.solvers import pose_graph as jpose_graph
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.solvers import pose_graph

torch.set_num_threads(2)

TOL_M = 1e-3
FIELDS = jpose_graph.PoseGraphProblem._fields


def fields(R, t, s, edges, K, fixed=0, pad=(0, 0)):
    """Problem fields from vertex estimates and (i, j, R, t, s) edges,
    with `pad` = (masked vertices, masked edges) appended as the loop
    closer pads to its buckets (identity vertices, edges 0-0)."""
    E = len(edges)
    pk, pe = pad
    eye = np.eye(3, dtype=np.float32)
    return dict(
        R=np.concatenate([R, np.tile(eye, (pk, 1, 1))]).astype(np.float32),
        t=np.concatenate([t, np.zeros((pk, 3))]).astype(np.float32),
        s=np.concatenate([s, np.ones(pk)]).astype(np.float32),
        fixed=np.concatenate([np.arange(K) == fixed, np.ones(pk, bool)]),
        vmask=np.concatenate([np.ones(K, bool), np.zeros(pk, bool)]),
        edge_i=np.array([e[0] for e in edges] + [0] * pe, np.int32),
        edge_j=np.array([e[1] for e in edges] + [0] * pe, np.int32),
        meas_R=np.concatenate([np.stack([e[2] for e in edges]),
                               np.tile(eye, (pe, 1, 1))]).astype(np.float32),
        meas_t=np.concatenate([np.stack([e[3] for e in edges]),
                               np.zeros((pe, 3))]).astype(np.float32),
        meas_s=np.concatenate([[e[4] for e in edges],
                               np.ones(pe)]).astype(np.float32),
        emask=np.concatenate([np.ones(E, bool), np.zeros(pe, bool)]),
    )


def centers(R, t, s):
    R, t, s = (np.asarray(x) for x in (R, t, s))
    return -np.einsum("kji,kj->ki", R, t) / s[:, None]


def noisy_loop():
    """Chain of keyframes around a circle with noisy odometry, and an
    exact loop edge back to the start."""
    rng = np.random.default_rng(6)
    K = 20
    R_true, t_true = [], []
    for k in range(K):
        th = 2 * np.pi * k / K
        Rw = Rotation.from_euler("y", th).as_matrix().astype(np.float32)
        C = np.array([5 * np.sin(th), 0.0, 5 - 5 * np.cos(th)], np.float32)
        R_true.append(Rw.T)
        t_true.append(-Rw.T @ C)
    R_true, t_true = np.stack(R_true), np.stack(t_true)
    R_est, t_est, edges = [R_true[0]], [t_true[0]], []
    for k in range(1, K):
        R_rel = R_true[k] @ R_true[k - 1].T
        t_rel = t_true[k] - R_rel @ t_true[k - 1]
        dR = Rotation.from_rotvec(rng.normal(0, 0.01, 3)).as_matrix()
        R_n = (dR @ R_rel).astype(np.float32)
        t_n = (t_rel + rng.normal(0, 0.02, 3)).astype(np.float32)
        edges.append((k - 1, k, R_n, t_n, 1.0))
        R_est.append(R_n @ R_est[-1])
        t_est.append(R_n @ t_est[-1] + t_n)
    R_rel = R_true[0] @ R_true[K - 1].T
    edges.append((K - 1, 0, R_rel.astype(np.float32),
                  t_true[0] - R_rel @ t_true[K - 1], 1.0))
    R_est, t_est = np.stack(R_est), np.stack(t_est)
    drift0 = np.linalg.norm(t_est[-1] - t_true[-1])

    def check(R, t, s):
        assert np.linalg.norm(np.asarray(t)[K - 1] - t_true[-1]) \
            < drift0 * 0.5
        np.testing.assert_allclose(np.asarray(s)[:K], 1.0, atol=0.05)

    return fields(R_est, t_est, np.ones(K), edges, K), 25, check


def ring(K, radius, dyaw, dstep, dscale, chords):
    th = 2 * np.pi * np.arange(K) / K
    Cs = np.stack([radius * np.cos(th), radius * np.sin(th), np.zeros(K)],
                  -1)
    Rw = Rotation.from_euler("z", th[:, None]).as_matrix()
    R_true = Rw.transpose(0, 2, 1).astype(np.float32)
    t_true = -np.einsum("kij,kj->ki", R_true, Cs).astype(np.float32)
    R_est, t_est, s_est = R_true.copy(), t_true.copy(), np.ones(K)
    accR, acct, accs = np.eye(3), np.zeros(3), 1.0
    dR = Rotation.from_euler("z", dyaw).as_matrix()
    for k in range(K):
        R_est[k] = R_true[k] @ accR.T
        t_est[k] = t_true[k] - R_true[k] @ accR.T @ acct
        s_est[k] = accs
        accR = accR @ dR
        acct = acct + np.asarray(dstep)
        accs *= dscale

    def rel(i, j):
        Rr = R_true[j] @ R_true[i].T
        return (i, j, Rr, t_true[j] - Rr @ t_true[i], 1.0)

    pairs = [(k, (k + 1) % K) for k in range(K)]
    if chords:
        pairs += [(k, (k + 5) % K) for k in range(0, K, 4)]
    return R_est, t_est, s_est, [rel(*p) for p in pairs], Cs


def exact_measurements():
    """Exact relative measurements: a drifted loop (rotation, translation
    and scale) must converge to the ground truth."""
    K = 30
    R, t, s, edges, Cs = ring(K, 8.0, 0.015, [0.03, 0.0, 0.015], 1.003,
                              False)

    def check(Ro, to, so):
        err = np.linalg.norm(centers(Ro, to, so)[:K] - Cs, axis=1).max()
        assert err < 5e-3, err

    return fields(R, t, s, edges, K), 20, check


def ring_with_chords(pad=(0, 0)):
    K = 40
    R, t, s, edges, Cs = ring(K, 6.0, 0.012, [0.02, 0.01, 0.0], 1.0, True)

    def check(Ro, to, so):
        err = np.linalg.norm(centers(Ro, to, so)[:K] - Cs, axis=1).max()
        assert err < 5e-3, err

    return fields(R, t, s, edges, K, pad=pad), 20, check


def scale_drift():
    """Monocular-style scale drift absorbed by the Sim3 vertices."""
    K = 10
    t_true = np.stack([np.array([k, 0, 0], np.float32) for k in range(K)])
    R_true = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t_est = t_true * (1.0 + 0.05 * np.arange(K)[:, None].astype(np.float32))
    eye = np.eye(3, dtype=np.float32)
    edges = [(k - 1, k, eye, t_true[k] - t_true[k - 1], 1.0)
             for k in range(1, K)]
    edges.append((K - 1, 0, eye, t_true[0] - t_true[K - 1], 1.0))
    err0 = np.abs(t_est - t_true).max()

    def check(R, t, s):
        assert np.abs(np.asarray(t)[:K] - t_true).max() < err0 * 0.5

    return fields(R_true, t_est, np.ones(K), edges, K), 30, check


PROBLEMS = {
    "noisy_loop": noisy_loop,
    "exact_measurements": exact_measurements,
    "ring_with_chords": ring_with_chords,
    "scale_drift": scale_drift,
    # the loop closer's padding: masked, frozen vertices and masked edges
    "ring_with_chords_padded": lambda: ring_with_chords(pad=(24, 40)),
}


@pytest.mark.parametrize("mode", ["dense", "cg"])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_optimize_matches_jax(name, mode):
    f, iters, check = PROBLEMS[name]()
    prob = convert.pose_graph_problem_from_numpy(**f)
    jprob = jpose_graph.PoseGraphProblem(
        **{k: jnp.asarray(v) for k, v in f.items()})
    got = [x.numpy() for x in pose_graph.optimize(prob, iters=iters,
                                                  mode=mode)]
    want = jpose_graph.optimize(jprob, iters=iters, mode=mode)
    dev = np.linalg.norm(centers(*got) - centers(*want), axis=1).max()
    assert dev < TOL_M, dev
    assert np.abs(got[2] - np.asarray(want[2])).max() < 1e-3
    assert np.isfinite(got[0]).all()
    check(*got)
    # frozen and masked vertices did not move
    still = f["fixed"] | ~f["vmask"]
    np.testing.assert_array_equal(got[1][still], f["t"][still])


def test_problem_from_numpy_types():
    f, _, _ = scale_drift()
    prob = convert.pose_graph_problem_from_numpy(**f)
    assert prob._fields == FIELDS
    assert prob.edge_i.dtype == torch.int64 and prob.R.dtype == torch.float32
    assert prob.fixed.dtype == torch.bool and prob.emask.dtype == torch.bool


def test_edge_jacobians_match_jax():
    """Residuals and both 7x7 Jacobians of every edge at the
    linearisation point, against JAX's vmap(jacfwd): within 1e-5."""
    f, _, _ = ring_with_chords()
    prob = convert.pose_graph_problem_from_numpy(**f)
    jprob = jpose_graph.PoseGraphProblem(
        **{k: jnp.asarray(v) for k, v in f.items()})
    r, Ji, Jj = pose_graph._edge_residual_jacobians(prob)
    jr, jJi, jJj = jpose_graph._edge_residual_jacobians(jprob)
    assert Ji.dtype == torch.float32 and torch.isfinite(Ji).all()
    for a, b in ((r, jr), (Ji, jJi), (Jj, jJj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)
    r2, none_i, none_j = pose_graph._edge_residual_jacobians(
        prob, jacobians=False)
    assert none_i is None and none_j is None and torch.equal(r, r2)
