"""Horn, EPnP RANSAC, Sim3 RANSAC + refinement and the sim(3) group of
the port against the JAX package on the CPU, on inputs made by numpy
from a seed and with the SAME RANSAC samples in both.  Outputs (R, t, s)
within TOL = 1e-4, inlier masks and counts equal; Jacobians at xi = 0
within 1e-5 of JAX's jacfwd.  Parity is held on the outputs only: `eigh`
fixes eigenvectors up to sign, so eigenvectors and betas are not
compared.  Mirrors tests/test_solvers.py::TestHorn / TestEPnP / TestSim3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from orb_slam2_tpu.geometry import sim3 as jsim3
from orb_slam2_tpu.solvers import epnp as jepnp
from orb_slam2_tpu.solvers import horn as jhorn
from orb_slam2_tpu.solvers import sim3_solver as jsolver
from orb_slam2_tpu_torch.geometry import se3, sim3
from orb_slam2_tpu_torch.solvers import epnp, horn, sim3_solver
from test_solvers import CX, CY, FX, FY, cam_pose, make_world, project

TOL = 1e-4
T = torch.from_numpy
CAM = (FX, FY, CX, CY)


def j(a):
    return jnp.asarray(a)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=0)


def pose_err(T_true, T_est):
    """max |se3.log(T_true^-1 T_est)| (metres / radians)."""
    d = torch.from_numpy((np.linalg.inv(T_true) @ T_est).astype(np.float32))
    return float(se3.log(d).abs().max())


# ---------------------------------------------------------------------------
# Horn
# ---------------------------------------------------------------------------
class TestHorn:
    @pytest.mark.parametrize("with_scale", [False, True])
    def test_batched_weighted_matches_jax(self, with_scale):
        rng = np.random.default_rng(4)
        p1 = rng.normal(0, 2, (16, 30, 3)).astype(np.float32)
        R = Rotation.random(16, random_state=rng).as_matrix().astype(
            np.float32)
        s = 1.7 if with_scale else 1.0
        p2 = (s * np.einsum("bij,bnj->bni", R, p1)
              + rng.normal(0, 1, (16, 1, 3))).astype(np.float32)
        w = (rng.random((16, 30)) > 0.2).astype(np.float32)
        p2[:, :3] += 10.0 * (1 - w[:, :3, None])    # masked rows are junk
        got = horn.horn_align(T(p1), T(p2), T(w), with_scale)
        want = jhorn.horn_align(j(p1), j(p2), j(w), with_scale)
        for g, wnt in zip(got, want):
            close(g, wnt)
        assert got[2].shape == (16,)
        if not with_scale:
            assert (got[2] == 1.0).all()

    def test_rigid_and_scale_recovery(self):
        rng = np.random.default_rng(5)
        p1 = rng.normal(0, 2, (30, 3)).astype(np.float32)
        R = Rotation.random(random_state=rng).as_matrix().astype(np.float32)
        t = rng.normal(0, 1, 3).astype(np.float32)
        p2 = (1.7 * (p1 @ R.T) + t).astype(np.float32)
        R2, t2, s2 = horn.horn_align(T(p1), T(p2), torch.ones(30), True)
        assert abs(float(s2) - 1.7) < 1e-3
        close(R2, R)
        close(t2, t, 1e-3)

    def test_nan_input_gives_nan_not_an_exception(self):
        """A degenerate hypothesis must come out NaN (and lose the
        inlier count), as in JAX; the solver behind eigh would raise."""
        p = torch.full((2, 5, 3), float("nan"))
        p[1] = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
        R, t, _ = horn.horn_align(p, p, torch.ones(2, 5), False)
        assert torch.isnan(R[0]).all() and torch.isfinite(R[1]).all()
        close(R[1], np.eye(3), 1e-5)


# ---------------------------------------------------------------------------
# EPnP
# ---------------------------------------------------------------------------
def pnp_both(pts, uv, max_err, mask, samples, **kw):
    got = epnp.solve_pnp_ransac(
        T(pts), T(uv.astype(np.float32)), T(max_err), T(mask),
        T(samples.astype(np.int64)), *CAM, **kw)
    want = jepnp.solve_pnp_ransac(
        j(pts), j(uv.astype(np.float32)), j(max_err), j(mask),
        j(samples.astype(np.int32)), *CAM, **kw)
    assert bool(got.success) == bool(want.success)
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    close(got.Tcw, want.Tcw)
    return got


class TestEPnP:
    def test_recovers_pose_with_outliers(self):
        rng = np.random.default_rng(10)
        n = 120
        pts = make_world(rng, n)
        T_true = cam_pose(rng, rot_deg=25, trans=1.0)
        pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
        keep = pc[:, 2] > 0.5
        uv = project(pc) + rng.normal(0, 0.5, (n, 2))
        n_out = 30
        uv[:n_out] = rng.uniform([0, 0], [640, 480], (n_out, 2))
        samples = np.stack(
            [rng.choice(n, epnp.MIN_SET, replace=False) for _ in range(300)])
        res = pnp_both(pts, uv, np.full(n, 5.991 * 4, np.float32), keep,
                       samples)
        assert bool(res.success)
        assert pose_err(T_true, res.Tcw.numpy()) < 0.05
        inl = res.inliers.numpy()
        assert inl[:n_out].mean() < 0.2
        assert inl[n_out:][keep[n_out:]].mean() > 0.85

    def test_padded_rows_and_degenerate_samples(self):
        """The relocalizer's call: 256 padded rows, 128 samples drawn
        WITH replacement (some repeat a row: a singular control-point
        system whose hypothesis must score nothing, not raise)."""
        rng = np.random.default_rng(21)
        n, n_pad = 180, 256
        pts = make_world(rng, n_pad)
        T_true = cam_pose(rng, rot_deg=15, trans=0.5)
        pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
        uv = project(pc) + rng.normal(0, 0.5, (n_pad, 2))
        uv[:50] = rng.uniform([0, 0], [640, 480], (50, 2))
        mask = np.arange(n_pad) < n
        pts[n:], uv[n:] = 0.0, 0.0
        samples = rng.integers(0, n, (128, 6))
        samples[7] = 60                 # all six the same row
        samples[8, :] = [61, 61, 61, 62, 62, 62]
        max_err = np.where(mask, 5.991 * 4, 0.0).astype(np.float32)
        res = pnp_both(pts, uv, max_err, mask, samples)
        assert bool(res.success)
        assert not res.inliers.numpy()[n:].any()
        assert pose_err(T_true, res.Tcw.numpy()) < 0.05

    @pytest.mark.parametrize("trial", range(4))
    def test_planar_scene_beta_cases(self, trial):
        """All world points on one plane: the 12x12 null space is more
        than one-dimensional, the case where the three beta seeds matter
        (ref: src/PnPsolver.cc:693-755)."""
        rng = np.random.default_rng(17 + trial)
        n = 100
        basis = Rotation.random(random_state=rng).as_matrix()
        pts = (np.concatenate(
            [rng.uniform(-3, 3, (n, 2)), np.zeros((n, 1))], 1
        ) @ basis.T).astype(np.float32)
        T_true = cam_pose(rng, rot_deg=20, trans=0.8)
        pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
        dz = max(0.0, 2.0 - float(pc[:, 2].min()))  # keep in front
        pc[:, 2] += dz
        T_true = T_true.copy()
        T_true[2, 3] += dz
        uv = project(pc) + rng.normal(0, 0.7, (n, 2))
        samples = np.stack([
            rng.choice(n, epnp.MIN_SET, replace=False) for _ in range(200)])
        got = epnp.solve_pnp_ransac(
            T(pts), T(uv.astype(np.float32)),
            torch.full((n,), 5.991 * 4), torch.ones(n, dtype=torch.bool),
            T(samples), *CAM)
        want = jepnp.solve_pnp_ransac(
            j(pts), j(uv.astype(np.float32)), jnp.full(n, 5.991 * 4),
            jnp.ones(n, bool), j(samples.astype(np.int32)), *CAM)
        # on a plane the hypotheses' eigenbases may differ between the
        # two packages: both must recover the pose, not equal each other
        assert bool(got.success) and bool(want.success)
        assert pose_err(T_true, got.Tcw.numpy()) < 0.08
        assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 3

    def test_failure_when_nothing_agrees(self):
        """Random pixels: no hypothesis gathers support and both packages
        report failure.  (Which hypothesis is 'best' among near-empty
        ones is not compared: a repeated row makes a singular system that
        LAPACK-in-XLA carries on from with finite junk and torch turns
        into NaN; either loses.)"""
        rng = np.random.default_rng(22)
        n = 64
        pts = make_world(rng, n)
        uv = rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32)
        samples = rng.integers(0, n, (64, 6))
        me = np.full(n, 5.991, np.float32)
        got = epnp.solve_pnp_ransac(
            T(pts), T(uv), T(me), torch.ones(n, dtype=torch.bool),
            T(samples), *CAM, min_inliers=30)
        want = jepnp.solve_pnp_ransac(
            j(pts), j(uv), j(me), jnp.ones(n, bool),
            j(samples.astype(np.int32)), *CAM, min_inliers=30)
        assert not bool(got.success) and not bool(want.success)
        assert int(got.n_inliers) < 30
        assert int(got.n_inliers) == int(got.inliers.sum())


# ---------------------------------------------------------------------------
# Sim3 RANSAC + refine
# ---------------------------------------------------------------------------
def sim3_world(rng, n, s, n_bad, n_live=None):
    pts2 = make_world(rng, n)
    R = Rotation.from_rotvec(rng.normal(0, 0.1, 3)).as_matrix().astype(
        np.float32)
    t = np.array([0.4, -0.2, 0.3], np.float32)
    pts1 = (s * (pts2 @ R.T) + t).astype(np.float32)
    uv1 = (project(pts1) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    uv2 = (project(pts2) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    pts2_c = pts2.copy()
    pts2_c[:n_bad] += rng.uniform(1, 3, (n_bad, 3)).astype(np.float32)
    mask = np.arange(n) < (n if n_live is None else n_live)
    return pts1, pts2_c, uv1, uv2, mask, R, t


def ransac_both(pts1, pts2, uv1, uv2, mask, samples, fix_scale, th=9.21 * 4):
    n = len(pts1)
    e = np.full(n, th, np.float32)
    got = sim3_solver.solve_sim3_ransac(
        T(pts1), T(pts2), T(uv1), T(uv2), T(e), T(e), T(mask),
        T(samples.astype(np.int64)), *CAM, fix_scale=fix_scale)
    want = jsolver.solve_sim3_ransac(
        j(pts1), j(pts2), j(uv1), j(uv2), j(e), j(e), j(mask),
        j(samples.astype(np.int32)), *CAM, fix_scale=fix_scale)
    assert bool(got.success) == bool(want.success)
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    close(got.R12, want.R12)
    close(got.t12, want.t12)
    close(got.s12, want.s12)
    return got, want


class TestSim3:
    def test_recovers_similarity(self):
        rng = np.random.default_rng(11)
        n, s = 80, 1.3
        pts1, pts2, uv1, uv2, mask, R, t = sim3_world(rng, n, s, 20)
        samples = np.stack(
            [rng.choice(n, 3, replace=False) for _ in range(200)])
        got, _ = ransac_both(pts1, pts2, uv1, uv2, mask, samples, False)
        assert bool(got.success)
        assert abs(float(got.s12) - s) < 0.02
        close(got.R12, R, 0.02)
        close(got.t12, t, 0.05)
        assert got.inliers.numpy()[:20].mean() < 0.3

    @pytest.mark.parametrize("fix_scale", [True, False])
    def test_bucket_shape_with_padding_then_refine(self, fix_scale):
        """The loop closer's calls: 512 padded rows, 128 samples with
        replacement, RANSAC then refine_sim3 from its estimate."""
        rng = np.random.default_rng(31 + fix_scale)
        n, live = 512, 300
        s = 1.0 if fix_scale else 1.15
        pts1, pts2, uv1, uv2, mask, R, t = sim3_world(rng, n, s, 60, live)
        samples = rng.integers(0, live, (128, 3))
        got, want = ransac_both(pts1, pts2, uv1, uv2, mask, samples,
                                fix_scale, th=9.21)
        assert bool(got.success)
        if fix_scale:
            assert float(got.s12) == 1.0
        one = np.ones(n, np.float32)
        rg = sim3_solver.refine_sim3(
            T(pts1), T(pts2), T(uv1), T(uv2), T(one), T(one), T(mask),
            got.R12, got.t12, got.s12, *CAM, fix_scale=fix_scale)
        rw = jsolver.refine_sim3(
            j(pts1), j(pts2), j(uv1), j(uv2), j(one), j(one), j(mask),
            want.R12, want.t12, want.s12, *CAM, fix_scale=fix_scale)
        for g, w in zip(rg[:3], rw[:3]):
            close(g, w)
        np.testing.assert_array_equal(rg[3].numpy(), np.asarray(rw[3]))
        assert int(rg[4]) == int(rw[4]) >= 200
        assert not rg[3].numpy()[live:].any()
        if fix_scale:
            assert float(rg[2]) == 1.0
        close(rg[0], R, 0.01)
        close(rg[1], t, 0.05)

    def test_refine_survives_outlier_majority(self):
        """Huber IRLS: a ~75% outlier fraction cannot drag the optimum
        away before the chi2 gate runs (ref: src/Optimizer.cc:1148-1171).
        """
        rng = np.random.default_rng(13)
        n_in, n_out = 35, 105
        n = n_in + n_out
        pts2 = make_world(rng, n)
        R = Rotation.from_rotvec(
            rng.normal(0, 0.1, 3)).as_matrix().astype(np.float32)
        t = np.array([0.3, -0.1, 0.2], np.float32)
        pts1 = (pts2 @ R.T + t).astype(np.float32)
        uv1 = (project(pts1) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
        uv2 = (project(pts2) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
        perm = n_in + rng.permutation(n_out)
        pts2_c = pts2.copy()
        pts2_c[n_in:] = pts2[perm]
        uv2_c = uv2.copy()
        uv2_c[n_in:] = uv2[perm]
        R0 = (Rotation.from_rotvec(rng.normal(0, 0.02, 3)).as_matrix()
              @ R).astype(np.float32)
        t0 = t + rng.normal(0, 0.05, 3).astype(np.float32)
        one = np.ones(n, np.float32)
        ones = np.ones(n, bool)
        rg = sim3_solver.refine_sim3(
            T(pts1), T(pts2_c), T(uv1), T(uv2_c), T(one), T(one), T(ones),
            T(R0), T(t0), torch.tensor(1.0), *CAM, fix_scale=True)
        rw = jsolver.refine_sim3(
            j(pts1), j(pts2_c), j(uv1), j(uv2_c), j(one), j(one), j(ones),
            j(R0), j(t0), jnp.float32(1.0), *CAM, fix_scale=True)
        for g, w in zip(rg[:3], rw[:3]):
            close(g, w)
        np.testing.assert_array_equal(rg[3].numpy(), np.asarray(rw[3]))
        assert int(rg[4]) >= int(0.8 * n_in)
        close(rg[0], R, 0.01)
        inl = rg[3].numpy()
        assert inl[:n_in].mean() > 0.8       # true matches kept
        assert inl[n_in:].mean() < 0.15      # wrong matches rejected


# ---------------------------------------------------------------------------
# the sim(3) group
# ---------------------------------------------------------------------------
def random_xi(rng, n, scale=1.0):
    xi = rng.normal(0, 1, (n, 7)).astype(np.float32) * scale
    xi[:, 6] *= 0.2
    return xi


class TestSim3Group:
    def test_exp_log_roundtrip_and_jax(self):
        xi = random_xi(np.random.default_rng(40), 64, 0.7)
        S = sim3.exp(T(xi))
        jS = jsim3.exp(j(xi))
        for a, b in zip(S, jS):
            close(a, b, 1e-5)
        close(sim3.log(S), xi, 1e-4)
        close(sim3.log(S), jsim3.log(jS), 1e-4)

    def test_compose_inverse_apply_matrix(self):
        rng = np.random.default_rng(41)
        A = sim3.exp(T(random_xi(rng, 8)))
        B = sim3.exp(T(random_xi(rng, 8)))
        p = T(rng.normal(0, 1, (8, 3)).astype(np.float32))
        close(sim3.apply(sim3.compose(A, B), p),
              sim3.apply(A, sim3.apply(B, p)), 1e-4)
        close(sim3.apply(sim3.inverse(A), sim3.apply(A, p)), p, 1e-4)
        R, t, s = sim3.from_matrix(sim3.matrix(A))
        close(R, A[0], 1e-5)
        close(t, A[1], 1e-6)
        close(s, A[2], 1e-5)
        T_se3 = sim3.to_se3(A)
        close(T_se3[:, :3, 3], A[1] / A[2][:, None], 1e-6)
        I = sim3.identity(batch=(3,))
        close(sim3.apply(I, p[:3]), p[:3], 0)
        F = sim3.from_se3(T_se3, 2.0)
        assert F[2].shape == (8,) and (F[2] == 2.0).all()

    @pytest.mark.parametrize("at_identity", [True, False])
    def test_edge_jacobian_at_zero_matches_jax_jacfwd(self, at_identity):
        """d log(exp(xi) o S) / d xi at xi = 0, the pose graph's
        linearisation point (finite and float32 under vmap + jacfwd)."""
        rng = np.random.default_rng(42)
        n = 12
        base = (np.zeros((n, 7), np.float32) if at_identity
                else random_xi(rng, n, 0.5))
        S = sim3.exp(T(base))
        jSs = jsim3.exp(j(base))

        def f(xi, R, t, s):
            return sim3.log(sim3.compose(sim3.exp(xi), (R, t, s)))

        J = torch.func.vmap(torch.func.jacfwd(f))(
            torch.zeros(n, 1, 7), *(x[:, None] for x in S))[:, 0, :, 0, :]

        def jf(xi, R, t, s):
            return jsim3.log(jsim3.compose(jsim3.exp(xi), (R, t, s)))

        Jj = jax.vmap(jax.jacfwd(jf))(jnp.zeros((n, 7)), *jSs)
        assert J.dtype == torch.float32 and torch.isfinite(J).all()
        close(J, Jj, 1e-5)
        if at_identity:
            close(J, np.broadcast_to(np.eye(7), (n, 7, 7)), 1e-6)
