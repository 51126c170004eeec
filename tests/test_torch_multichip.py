"""The port's multi-device paths on 4 gloo ranks (CPU): the 3 cases of
tests/test_multichip.py, each against the port's unsharded function and
against the JAX package's unsharded `frontend.extract` and `ba.optimize`,
at the JAX tests' own sizes (8 frames, 2 a rank; a BA of 4 cameras, 64
points and 512 edges, 128 a rank, 4 LM iterations, the dry run's
`ba_problem`: the JAX recipe with cameras 0 and 1 fixed).

Tolerances: extraction equal to the port's unsharded frontend; against
JAX's, xy / octave / valid equal and descriptors identical on >= 99% of
valid rows (the frontend's own parity bound).  BA against JAX's unsharded
optimizer on the same problem at the JAX test's rtol 1e-2 / atol 5e-3
(the final error at rtol 1e-2), against the port's at atol 1e-4 (measured
4.2e-7 on cameras, 4.3e-6 m on points) and the error at rtol 1e-5
(measured 3.6e-7).  Why the second fixed camera: with the JAX recipe's
one, the scale is free, and the all-reduce's other order of f32 sums
moved cameras by 4e-3 here (`ba_problem`'s docstring).  The tracking
step finite and each frame equal to the port's unsharded step.

Also: the `python -m orb_slam2_tpu_torch.parallel.dryrun 4 --device cpu`
entry point, a rank that fails and a run that outlasts its timeout each
raising in the launcher with no rank left alive, and
`ba.optimize(edge_reduce=None)` unchanged by the hook.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.ops import frontend as jfrontend
from orb_slam2_tpu.parallel import multichip as jmultichip
from orb_slam2_tpu.solvers import ba as jba
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.ops import frontend
from orb_slam2_tpu_torch.parallel import dryrun, multichip
from orb_slam2_tpu_torch.slam import track_step
from orb_slam2_tpu_torch.solvers import ba

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
N_RANKS = 4
B = 8                   # the JAX tests' batch: 8 frames
LAUNCH_TIMEOUT_S = 300.0
PORT_ATOL = 1e-4
PORT_ERR_RTOL = 1e-5


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Rank 0's sharded results of the dry run's checks on 4 gloo ranks
    (every rank has also held them against the unsharded functions)."""
    d = tmp_path_factory.mktemp("dryrun")
    dryrun.launch(dryrun.checks, N_RANKS, "cpu", args=(str(d), B),
                  timeout=LAUNCH_TIMEOUT_S)
    with np.load(d / "sharded.npz") as z:
        return dict(z)


def _images():
    return np.random.default_rng(0).uniform(0, 255, (B, 96, 128)).astype(
        np.float32)


def test_extract_batch_sharded_matches_single_device(sharded):
    imgs = _images()
    desc = sharded["extract_desc"].view(np.uint32)
    assert desc.shape[0] == B
    for i in range(B):
        f = convert.features_to_numpy(frontend.extract(
            torch.from_numpy(imgs[i]), 128, 3, 1.2, 20, 7, 24))
        np.testing.assert_array_equal(desc[i], f["desc"])
        for k in ("xy", "octave", "valid"):
            np.testing.assert_array_equal(sharded[f"extract_{k}"][i], f[k])
    # frame 0 against the JAX package's unsharded frontend
    j = jfrontend.extract(jnp.asarray(imgs[0]), 128, 3, 1.2, 20, 7, 24)
    for k in ("xy", "octave", "valid"):
        np.testing.assert_array_equal(sharded[f"extract_{k}"][0],
                                      np.asarray(getattr(j, k)))
    v = sharded["extract_valid"][0]
    assert v.sum() > 20
    same = (desc[0] == np.asarray(j.desc)).all(1)[v]
    assert same.mean() >= 0.99, same.mean()


def test_optimize_sharded_parity_with_single_device(sharded):
    prob, k = dryrun.ba_problem("cpu")
    jprob, jk = jmultichip.synthetic_ba_problem(n_cams=4, n_pts=64,
                                                n_edges=64 * B)
    assert k == jk
    for t, j in zip(prob, jprob):       # the same seeded problem ...
        if t is not prob.cam_fixed:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # ... with cameras 0 and 1 fixed
    assert prob.cam_fixed.tolist() == [True, True, False, False]
    jprob = jprob._replace(cam_fixed=jnp.asarray(prob.cam_fixed.numpy()))
    iters = dryrun.BA_ITERS
    cam_s, pts_s, err_s = (sharded["ba_cam_T"], sharded["ba_pts"],
                           float(sharded["ba_err"]))
    # against the JAX package's unsharded optimizer, at its test's bounds
    cam_j, pts_j, err_j = jba.optimize(jprob, *jk, iters=iters,
                                       use_kernel=True, mode="cg")
    np.testing.assert_allclose(cam_s, np.asarray(cam_j), rtol=1e-2,
                               atol=5e-3)
    np.testing.assert_allclose(pts_s, np.asarray(pts_j), rtol=1e-2,
                               atol=5e-3)
    np.testing.assert_allclose(err_s, float(err_j), rtol=1e-2)
    # against the port's unsharded optimizer: only the sums' order differs
    cam_1, pts_1, err_1 = ba.optimize(prob, *k, iters=iters,
                                      use_kernel=True, mode="cg")
    np.testing.assert_allclose(cam_s, cam_1.numpy(), rtol=0, atol=PORT_ATOL)
    np.testing.assert_allclose(pts_s, pts_1.numpy(), rtol=0, atol=PORT_ATOL)
    np.testing.assert_allclose(err_s, float(err_1), rtol=PORT_ERR_RTOL)
    # and it optimizes: the final error beats one iteration's
    _, _, err0 = ba.optimize(prob, *k, iters=1, use_kernel=True, mode="cg")
    assert err_s <= float(err0) + 1e-6
    # every edge sum all-reduced: 5 in the assembly, 1 for the CG's
    # right-hand side, 2 a matvec (61 of them), 1 in the back-substitution,
    # 1 for the proposal's error
    assert float(sharded["ba_reduces_per_iter"]) == 5 + 1 + 2 * 61 + 1 + 1


def test_track_step_sharded_runs_and_is_finite(sharded):
    settings = dryrun._stereo_settings()
    args, (L, M) = dryrun.track_inputs(B, settings)
    pack, desc = sharded["track_f32_pack"], sharded["track_desc"]
    assert pack.shape[0] == desc.shape[0] == B
    # the descriptor tail is int32 bits viewed as f32: only the numeric
    # prefix must be finite
    assert np.isfinite(pack[:, : pack.shape[1] - 8 * L]).all()
    step = track_step.build_track_step(settings, "stereo", device="cpu")
    names = ("img_l", "img_r", "scal", "last_f32", "last_desc", "last_oct",
             "last_angle", "loc_f32", "loc_desc")
    for i in range(B):
        one = step(*convert.track_inputs_from_numpy(
            {k: a[i] for k, a in zip(names, args)}))
        np.testing.assert_array_equal(pack[i].view(np.int32),
                                      one.f32_pack.numpy().view(np.int32))
        np.testing.assert_array_equal(desc[i], one.desc.numpy())


def test_dryrun_entry_point_on_four_cpu_ranks():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "orb_slam2_tpu_torch.parallel.dryrun",
         str(N_RANKS), "--device", "cpu", "--timeout", "240"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "dryrun_multichip OK: 4 ranks" in proc.stdout


def test_a_failing_rank_raises_and_leaves_no_rank_alive():
    """3 frames do not split over 4 ranks: every rank raises inside the
    group, and the launcher reports it instead of waiting."""
    with pytest.raises(Exception, match="do not split"):
        dryrun.launch(dryrun.checks, N_RANKS, "cpu", args=(None, 3),
                      timeout=LAUNCH_TIMEOUT_S)
    import multiprocessing

    assert not multiprocessing.active_children()


def test_a_run_past_its_timeout_raises_and_leaves_no_rank_alive():
    with pytest.raises(TimeoutError):
        dryrun.launch(dryrun.checks, 2, "cpu", timeout=0.5)
    import multiprocessing

    assert not multiprocessing.active_children()


def test_launch_refuses_more_ranks_than_cards():
    with pytest.raises(ValueError, match="cards"):
        dryrun.launch(dryrun.checks, torch.cuda.device_count() + 1, "cuda")


@pytest.mark.parametrize("mode,reduces", [("dense", 8), ("cg", 130)])
def test_edge_reduce_none_is_the_unsharded_arithmetic(mode, reduces):
    """The hook changes nothing when absent: an identity reducer gives the
    same bits as edge_reduce=None, and is called at every edge sum (dense:
    4 in the assembly, the error, W, the back-substitution, the proposal's
    error; cg: see above)."""
    prob, k = multichip.synthetic_ba_problem(8, 128, 1024, device="cpu")
    calls = []

    def identity(t):
        calls.append(tuple(t.shape))
        return t

    a = ba.optimize(prob, *k, iters=3, mode=mode)
    b = ba.optimize(prob, *k, iters=3, mode=mode, edge_reduce=None)
    c = ba.optimize(prob, *k, iters=3, mode=mode, edge_reduce=identity)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert len(calls) == 3 * reduces


def test_ba_problem_fixes_the_scale_gauge():
    """Why the dry run fixes a second camera: another order of the same
    edges (what sharding does to the sums) moves the JAX recipe's cameras
    past the JAX bound of 5e-3, and leaves `ba_problem`'s within 1e-4."""
    free, k = multichip.synthetic_ba_problem(4, 64, 512, device="cpu")
    fixed, _ = dryrun.ba_problem("cpu")
    perm = torch.from_numpy(np.random.default_rng(0).permutation(512))

    def reordered(p):
        return p._replace(**{f: getattr(p, f)[perm] for f in (
            "edge_cam", "edge_pt", "edge_uv", "edge_inv_sigma2",
            "edge_mask")})

    moved = {}
    for name, p in (("free", free), ("fixed", fixed)):
        a = ba.optimize(p, *k, iters=dryrun.BA_ITERS, mode="cg")
        b = ba.optimize(reordered(p), *k, iters=dryrun.BA_ITERS, mode="cg")
        moved[name] = float((a[0] - b[0]).abs().max())
        assert abs(float(a[2]) / float(b[2]) - 1.0) < 1e-5
    assert moved["free"] > 5e-3 and moved["fixed"] < 1e-4, moved


def test_mesh_needs_an_initialised_group():
    with pytest.raises(RuntimeError, match="not initialised"):
        multichip.make_mesh()
