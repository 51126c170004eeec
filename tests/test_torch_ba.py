"""Bundle adjustment of the port: the six cases of tests/test_ba.py's
TestBA on the port's solver, and parity with the JAX solver on the same
`build_problem` inputs in each reduction route (one-hot matmul, scatter)
and in cg mode.

Parity tolerances: on stereo problems (metric scale observable) poses
within 1e-4 and points within 1e-3 m of JAX after 10 LM iterations, and
the local-BA chain's outlier masks equal.  Monocular problems with one
fixed camera leave the scale free, so the two frameworks' float32 sums
walk different distances along that flat valley (measured: the same cost
to 6 digits at pose distances from the truth of 0.013 and 0.018): there
the final cost agrees within 1e-5 relative and the poses move toward the
truth.
"""

import numpy as np
import pytest
import torch

from orb_slam2_tpu.solvers import ba as jba
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.geometry import se3 as tse3
from orb_slam2_tpu_torch.solvers import ba

from test_ba import CX, CY, FX, FY, build_problem

torch.set_num_threads(2)


def tprob(prob):
    return convert.ba_problem_from_numpy(*[np.asarray(a) for a in prob])


def pose_errors(cam_T, cams_true):
    cam_T = torch.as_tensor(np.array(cam_T))
    d = torch.linalg.inv(torch.from_numpy(np.asarray(cams_true))) @ cam_T
    return tse3.log(d).abs().amax(-1).numpy()


class TestBA:
    def test_dense_mono_converges(self):
        rng = np.random.default_rng(0)
        prob, cams, pts, bf = build_problem(rng, noise=0.3)
        p = tprob(prob)
        cam_T, pts_o, err = ba.optimize(p, FX, FY, CX, CY, bf, iters=15)
        e0 = pose_errors(p.cam_T, cams)
        e1 = pose_errors(cam_T, cams)
        assert e1.max() < e0.max() * 0.5
        assert e1.max() < 0.015, e1

    def test_dense_stereo_converges(self):
        rng = np.random.default_rng(1)
        prob, cams, pts, bf = build_problem(rng, noise=0.3, stereo=True)
        p = tprob(prob)
        cam_T, pts_o, err = ba.optimize(p, FX, FY, CX, CY, bf, iters=20)
        e1 = pose_errors(cam_T, cams)
        assert e1.max() < 0.02, e1
        d0 = np.abs(p.pts.numpy() - pts).mean()
        d1 = np.abs(pts_o.numpy() - pts).mean()
        assert d1 < d0 * 0.7

    def test_cg_matches_dense(self):
        rng = np.random.default_rng(2)
        prob, cams, pts, bf = build_problem(rng, noise=0.3)
        p = tprob(prob)
        Td, _, _ = ba.optimize(p, FX, FY, CX, CY, bf, iters=10, mode="dense")
        Tc, _, _ = ba.optimize(p, FX, FY, CX, CY, bf, iters=10, mode="cg",
                               cg_iters=80)
        ed = pose_errors(Td, cams)
        ec = pose_errors(Tc, cams)
        assert ec.max() < max(ed.max() * 3, 0.01), (ed, ec)

    def test_outlier_classification(self):
        rng = np.random.default_rng(3)
        prob, cams, pts, bf = build_problem(rng, noise=0.3)
        p = tprob(prob)
        uv = p.edge_uv.clone()
        n_bad = 40
        bad_idx = rng.choice(len(uv), n_bad, replace=False)
        uv[bad_idx, :2] += torch.from_numpy(
            rng.uniform(15, 40, (n_bad, 2)).astype(np.float32))
        p = p._replace(edge_uv=uv)
        cam_T, pts_o, _ = ba.optimize(p, FX, FY, CX, CY, bf, iters=10)
        p2 = p._replace(cam_T=cam_T, pts=pts_o)
        out = ba.classify_outliers(p2, FX, FY, CX, CY, bf).numpy()
        assert out[bad_idx].mean() > 0.9
        good = np.ones(len(uv), bool)
        good[bad_idx] = False
        assert out[good].mean() < 0.1
        p3 = p2._replace(edge_mask=torch.from_numpy(~out))
        cam_T2, _, _ = ba.optimize(p3, FX, FY, CX, CY, bf, iters=10)
        e2 = pose_errors(cam_T2, cams)
        assert e2.max() < 0.02, e2

    def test_fixed_cameras_stay_fixed(self):
        rng = np.random.default_rng(4)
        prob, cams, pts, bf = build_problem(rng)
        p = tprob(prob)
        cam_T, _, _ = ba.optimize(p, FX, FY, CX, CY, bf, iters=5)
        assert torch.equal(cam_T[0], p.cam_T[0])

    def test_padded_slots_untouched(self):
        rng = np.random.default_rng(5)
        prob, cams, pts, bf = build_problem(rng, n_cams=4, n_pts=100)
        p = tprob(prob)
        eye = torch.eye(4).expand(2, 4, 4)
        p = p._replace(
            cam_T=torch.cat([p.cam_T, eye]),
            cam_fixed=torch.cat([p.cam_fixed, torch.zeros(2, dtype=bool)]),
            cam_mask=torch.cat([p.cam_mask, torch.zeros(2, dtype=bool)]),
            pts=torch.cat([p.pts, torch.zeros((20, 3))]),
            pt_mask=torch.cat([p.pt_mask, torch.zeros(20, dtype=bool)]),
        )
        cam_T, pts_o, _ = ba.optimize(p, FX, FY, CX, CY, bf, iters=5)
        assert torch.equal(cam_T[4:], eye)
        assert (pts_o[100:] == 0).all()


# (mode, E*P gate of the one-hot route): the one-hot route, the scatter
# route (a gate of 0 sends every problem to index_add_), cg
ROUTES = {"onehot": ("dense", ba.ONEHOT_MAX_ENTRIES),
          "scatter": ("dense", 0), "cg": ("cg", ba.ONEHOT_MAX_ENTRIES)}


def set_route(monkeypatch, route):
    mode, gate = ROUTES[route]
    monkeypatch.setattr(ba, "ONEHOT_MAX_ENTRIES", gate)
    return mode


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_optimize_matches_jax_stereo(route, monkeypatch):
    mode = set_route(monkeypatch, route)
    rng = np.random.default_rng(11)
    prob, cams, pts, bf = build_problem(rng, noise=0.3, stereo=True)
    Tj, pj, ej = jba.optimize(prob, FX, FY, CX, CY, bf, iters=10, mode=mode)
    Tt, pt_, et = ba.optimize(tprob(prob), FX, FY, CX, CY, bf, iters=10,
                              mode=mode)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(pt_.numpy(), np.asarray(pj), atol=1e-3)
    assert abs(float(et) - float(ej)) <= 1e-5 * float(ej)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_optimize_matches_jax_mono(route, monkeypatch):
    mode = set_route(monkeypatch, route)
    rng = np.random.default_rng(12)
    prob, cams, pts, bf = build_problem(rng, noise=0.3)
    Tj, _, ej = jba.optimize(prob, FX, FY, CX, CY, bf, iters=10, mode=mode)
    Tt, _, et = ba.optimize(tprob(prob), FX, FY, CX, CY, bf, iters=10,
                            mode=mode)
    assert abs(float(et) - float(ej)) <= 1e-5 * float(ej)
    e0 = pose_errors(np.asarray(prob.cam_T), cams).max()
    assert pose_errors(Tt, cams).max() < e0


@pytest.mark.parametrize("route", ["onehot", "scatter"])
@pytest.mark.parametrize("second_round", [True, False])
def test_local_ba_chain_matches_jax(route, second_round, monkeypatch):
    """The whole local-BA chain, with 30 corrupted observations: poses,
    points and the final outlier mask against JAX."""
    set_route(monkeypatch, route)
    rng = np.random.default_rng(13)
    prob, cams, pts, bf = build_problem(rng, noise=0.3, stereo=True)
    uv = np.array(prob.edge_uv)
    bad_idx = rng.choice(len(uv), 30, replace=False)
    uv[bad_idx, :2] += rng.uniform(15, 40, (30, 2))
    prob = prob._replace(edge_uv=uv)
    cj = jba.local_ba_chain(prob, FX, FY, CX, CY, bf,
                            second_round=second_round)
    ct = ba.local_ba_chain(tprob(prob), FX, FY, CX, CY, bf,
                           second_round=second_round)
    np.testing.assert_allclose(ct[0].numpy(), np.asarray(cj[0]), atol=1e-4)
    np.testing.assert_allclose(ct[1].numpy(), np.asarray(cj[1]), atol=1e-3)
    np.testing.assert_array_equal(ct[2].numpy(), np.asarray(cj[2]))
    np.testing.assert_array_equal(ct[3].numpy(), np.asarray(cj[3]))
    assert ct[2].numpy()[bad_idx].all()
