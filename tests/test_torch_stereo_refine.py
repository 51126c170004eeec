"""The fused stereo refinement (csrc/stereo.cu stereo_refine_kernel), held
on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it against
`stereo_cuda.refine_plain` bit for bit.  These tests hold, without a card:

  (a) stereo.match, whose step 3 is now `stereo_cuda.refine`, against the
      JAX package's stereo.match on a rendered pair: exactly equal;
  (b) a numpy transcription of the kernel -- its staged window, its lane
      partition of the window pixels, its butterfly reduce-scatter, its
      first-minimum rule and its float32 epilogue, in the kernel's order
      of operations -- against refine_plain: exactly equal on random
      integer images and on hand-made windows for each branch;
  (c) the wrappers: refine_cuda refuses CPU tensors, refine sends any
      other device to the kernel, and nothing is built on the CPU.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.ops import frontend as jfrontend
from orb_slam2_tpu.ops import stereo as jstereo
from orb_slam2_tpu_torch.ops import cuda_build, stereo, stereo_cuda

torch.set_num_threads(2)

f32 = np.float32
W, L = stereo_cuda.W, stereo_cuda.L
N_SHIFTS = 2 * L + 1
STRIP = 2 * (W + L) + 1          # 21 right-strip columns a staged row
LANES = np.arange(32)
_SOURCE = (Path(stereo_cuda.__file__).resolve().parent.parent / "csrc"
           / "stereo.cu").read_text()
ROW_STRIDE = int(re.search(r"kRowStride = (\d+);", _SOURCE).group(1))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scalars(bf, min_disp, max_disp):
    return [torch.tensor(v, dtype=torch.float32)
            for v in (bf, min_disp, max_disp)]


# ------------------------------------------------- (b) the transcription


def _kernel_centres(xy_l, xy_r, best_idx, h, w):
    """(int) truncation toward zero, then the clamps."""
    yc = np.clip(xy_l[:, 1].astype(np.int32), W, h - 1 - W)
    xl = np.clip(xy_l[:, 0].astype(np.int32), W + L, w - 1 - W - L)
    xr = np.clip(xy_r[best_idx, 0].astype(np.int32), W + L, w - 1 - W - L)
    return yc, xl, xr


def _stage(left, right, yc, xl, xr):
    """The warp's staged window, (n, 11, ROW_STRIDE): lane j's load of
    row r lands at [r, j]; lanes 0..20 read the right strip, 21..31 the
    left window."""
    win = np.zeros((yc.shape[0], 2 * W + 1, ROW_STRIDE), f32)
    cols_r = xr[:, None] - W - L + LANES[None, :STRIP]
    cols_l = xl[:, None] - W + (LANES[None, STRIP:] - STRIP)
    for r in range(2 * W + 1):
        y = (yc - W + r)[:, None]
        win[:, r, :STRIP] = right[y, cols_r]
        win[:, r, STRIP:32] = left[y, cols_l]
    return win


def _warp_sads(win):
    """(n, 32): each lane's value after the butterfly; lane j holds the
    SAD of shift j >> 1."""
    n = win.shape[0]
    lc = win[:, W, STRIP + W]
    rc = win[:, W, W:W + N_SHIFTS]
    acc = np.zeros((n, 32, 16), f32)
    for k in range(4):
        for lane in range(32):
            p = lane + 32 * k
            if p >= (2 * W + 1) ** 2:
                continue
            dy, dx = divmod(p, 2 * W + 1)
            ln = win[:, dy, STRIP + dx] - lc
            for s in range(N_SHIFTS):
                acc[:, lane, s] = acc[:, lane, s] + np.abs(
                    ln - (win[:, dy, dx + s] - rc[:, s]))
    half = 8
    while half >= 1:
        upper = (LANES & (2 * half)) != 0
        partner = LANES ^ (2 * half)
        nxt = np.empty((n, 32, half), f32)
        for j in range(half):
            slot = np.where(upper, j + half, j)
            # the partner sends the slot this lane keeps
            nxt[:, :, j] = acc[:, LANES, slot] + acc[:, partner, slot]
        acc, half = nxt, half // 2
    return acc[:, :, 0] + acc[:, LANES ^ 1, 0]


def _epilogue(sads, u_l, xr, best_dist, bf, min_disp, max_disp):
    n = sads.shape[0]
    rows = np.arange(n)
    key = np.where(LANES < 2 * N_SHIFTS, sads.view(np.uint32),
                   np.uint32(0xFFFFFFFF))
    best_key = key.min(1)
    best_s = np.where(key == best_key[:, None], LANES >> 1, 99).min(1)
    best = best_key.astype(np.uint32).view(f32)
    im1 = sads[rows, 2 * np.maximum(best_s - 1, 0)]
    ip1 = sads[rows, 2 * np.minimum(best_s + 1, 2 * L)]
    interior = (best_s > 0) & (best_s < 2 * L)
    denom = (im1 + ip1) - f32(2.0) * best
    take = interior & (denom > f32(1e-6))
    delta = np.zeros(n, f32)
    delta[take] = ((f32(0.5) * (im1 - ip1))[take]
                   / np.maximum(denom, f32(1e-6))[take])
    delta = np.minimum(np.maximum(delta, f32(-1.0)), f32(1.0))
    u = (xr.astype(f32) + (best_s - L).astype(f32)) + delta
    disparity = u_l - u
    good = ((best_dist < stereo_cuda.TH_ORB) & (disparity >= min_disp)
            & (disparity < max_disp))
    disparity = np.where(disparity <= 0, f32(0.01), disparity)
    with np.errstate(divide="ignore"):
        depth = f32(bf) / disparity
    out = (np.where(good, u, f32(-1.0)), np.where(good, depth, f32(-1.0)),
           np.where(good, best, f32(np.inf)))
    return out, {"best_s": best_s, "delta": delta, "good": good}


def kernel_numpy(left, right, xy_l, xy_r, best_idx, best_dist, bf,
                 min_disp, max_disp):
    """csrc/stereo.cu stereo_refine_kernel, transcribed in numpy float32.
    Returns ((u_right, depth, sad), scores (n, 11), internals)."""
    h, w = left.shape
    yc, xl, xr = _kernel_centres(xy_l, xy_r, best_idx, h, w)
    sads = _warp_sads(_stage(left, right, yc, xl, xr))
    out, internals = _epilogue(sads, xy_l[:, 0], xr, best_dist, f32(bf),
                               f32(min_disp), f32(max_disp))
    return out, sads[:, 0:2 * N_SHIFTS:2], internals


def _plain(left, right, xy_l, xy_r, best_idx, best_dist, bf, min_disp,
           max_disp):
    out = stereo_cuda.refine_plain(
        _t(left), _t(right), _t(xy_l), _t(xy_r), _t(best_idx),
        _t(best_dist), *_scalars(bf, min_disp, max_disp))
    return [o.numpy() for o in out]


def test_row_stride_spreads_every_read_over_32_banks():
    """The kernel's claim about kRowStride: for each pixel round k and each
    shift s, the 32 lanes' right-strip reads (and their left-window reads)
    fall in 32 distinct banks, or as many as there are active lanes."""
    for k in range(4):
        p = LANES + 32 * k
        p = p[p < (2 * W + 1) ** 2]
        dy, dx = np.divmod(p, 2 * W + 1)
        for off in [*range(N_SHIFTS), STRIP]:
            banks = (dy * ROW_STRIDE + dx + off) % 32
            assert len(set(banks.tolist())) == p.size, (k, off)


@pytest.mark.parametrize("seed", [0, 1])
def test_transcription_equals_plain_on_random_integer_images(seed):
    """Random integer images, keypoints all over the image (centres past
    every clamp limit included), Hamming distances on both sides of the
    threshold: the transcription's outputs and scores equal refine_plain's
    and sad_strips_plain's exactly."""
    rng = np.random.default_rng(seed)
    h, w, n = 128, 384, 256
    left = rng.integers(0, 256, (h, w)).astype(f32)
    right = rng.integers(0, 256, (h, w)).astype(f32)
    xy_l = np.stack([rng.uniform(-4, w + 4, n),
                     rng.uniform(-4, h + 4, n)], 1).astype(f32)
    disp = rng.uniform(-5, 70, n).astype(f32)
    best_idx = rng.permutation(n).astype(np.int64)
    xy_r = np.empty_like(xy_l)
    xy_r[best_idx] = xy_l - np.stack([disp, np.zeros(n, f32)], 1)
    best_dist = rng.integers(60, 90, n).astype(np.int32)
    args = (left, right, xy_l, xy_r, best_idx, best_dist, 110.0, 0.0, 220.0)
    (u, d, s), scores, _ = kernel_numpy(*args)
    pu, pd, ps = _plain(*args)
    np.testing.assert_array_equal(u, pu)
    np.testing.assert_array_equal(d, pd)
    np.testing.assert_array_equal(s, ps)
    centres = stereo_cuda.centres(_t(xy_l), _t(xy_r), _t(best_idx), h, w)
    np.testing.assert_array_equal(
        scores, stereo_cuda.sad_strips_plain(_t(left), _t(right),
                                             *centres).numpy())
    assert 20 < int((pd > 0).sum()) < n


def _window_pair(target, h=24, w=64, yc=12, xl=30, xr=30):
    """Images whose windows at (yc, xl) and (yc, xr) give the SAD scores
    `target` + C for the smallest C >= 0 that fits: the centre rows are 0,
    the right strip's top row holds a(c) (the window at shift s sums a(s)
    .. a(s+10)) and a left row, over a zero right row, adds a constant K.
    Values are dyadic, so every sum is exact in any order."""
    t = np.asarray(target, np.float64)
    a = np.zeros(STRIP)
    a[:N_SHIFTS - 1] = np.maximum(t[:-1] - t[1:], 0.0)
    a[N_SHIFTS:] = a[:N_SHIFTS - 1] + t[1:] - t[:-1]
    k = t[0] - a[:N_SHIFTS].sum()
    t = t + max(-k, 0.0)
    left = np.zeros((h, w), f32)
    right = np.zeros((h, w), f32)
    right[yc - W, xr - W - L:xr + W + L + 1] = a
    left[yc - W + 1, xl - W] = max(k, 0.0)
    return left, right, t.astype(f32)


# name: (target SADs, keypoint / match overrides, the branch to check)
_GROW = [4.0 * i for i in range(N_SHIFTS)]
_E = 2.0 ** -22
_CASES = {
    "flat_window": ([0.0] * N_SHIFTS, {}, {"best_s": 0, "delta": 0.0}),
    "min_at_shift_0": (_GROW, {}, {"best_s": 0, "delta": 0.0}),
    "min_at_shift_10": (_GROW[::-1], {}, {"best_s": 10, "delta": 0.0}),
    "two_way_tie": ([9, 7, 3, 6, 8, 5, 3, 4, 9, 9, 9], {},
                    {"best_s": 2, "delta": f32(0.5) / f32(7.0)}),
    "denom_at_most_1e-6": ([2, 2, 1 + _E, 1, 1 + _E, 2, 2, 2, 2, 2, 2], {},
                           {"best_s": 3, "delta": 0.0}),
    "denom_just_above_1e-6": (
        [2, 2, 1 + 4 * _E, 1, 1 + 8 * _E, 2, 2, 2, 2, 2, 2], {},
        {"best_s": 3, "delta": f32(-1 / 6)}),
    # |delta| <= 0.5 whenever best is the first minimum, so the clamp to
    # +-1 never binds; this is the largest |delta| a window can give
    "delta_at_its_bound": ([9, 9, 9, 7, 3, 3, 9, 9, 9, 9, 9], {},
                           {"best_s": 4, "delta": 0.5}),
    "disparity_negative_snapped": (
        _GROW, {"u_l": 20.25, "min_disp": -20.0},
        {"good": True, "depth": f32(110.0) / f32(0.01)}),
    "disparity_zero_snapped": (_GROW, {"u_l": 25.0},
                               {"good": True,
                                "depth": f32(110.0) / f32(0.01)}),
    "disparity_at_min_disp": (_GROW, {"u_l": 32.0, "min_disp": 7.0},
                              {"good": True}),
    "disparity_at_max_disp": (_GROW, {"u_l": 32.0, "max_disp": 7.0},
                              {"good": False}),
    "best_dist_74": (_GROW, {"best_dist": 74}, {"good": True}),
    "best_dist_75": (_GROW, {"best_dist": 75}, {"good": False}),
    "yc_clamped_low": (_GROW, {"v_l": -0.75}, {"good": True}),
    "yc_clamped_high": (_GROW, {"v_l": 27.5}, {"good": True}),
    "xl_clamped_low": (_GROW, {"u_l": -0.5, "min_disp": -99.0},
                       {"good": True}),
    "xl_clamped_high": (_GROW, {"u_l": 70.5}, {"good": True}),
    "xr_clamped_low": (_GROW, {"u_r": 3.9, "u_l": 40.0}, {"good": True}),
    "xr_clamped_high": (_GROW, {"u_r": 66.2, "u_l": 63.0}, {"good": True}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_transcription_equals_plain_on_hand_made_windows(case):
    """One keypoint a case, its windows built to give chosen SAD scores;
    the transcription equals refine_plain exactly, and the case takes the
    branch it names."""
    target, over, expect = _CASES[case]
    h, w = 24, 64
    # default centres (12, 30, 30), with fractional parts that truncation
    # drops; a case past a clamp limit moves the windows to the limit
    xy_l = np.array([[over.get("u_l", 30.25), over.get("v_l", 12.5)]], f32)
    xy_r = np.array([[0.0, 0.0], [over.get("u_r", 30.75), 12.5]], f32)
    yc, xl, xr = (int(c[0]) for c in _kernel_centres(
        xy_l, xy_r, np.array([1]), h, w))
    left, right, target = _window_pair(target, h, w, yc, xl, xr)
    best_idx = np.array([1], np.int64)
    best_dist = np.array([over.get("best_dist", 10)], np.int32)
    args = (left, right, xy_l, xy_r, best_idx, best_dist, 110.0,
            over.get("min_disp", 0.0), over.get("max_disp", 64.0))
    out, scores, internals = kernel_numpy(*args)
    np.testing.assert_array_equal(scores[0], target)
    for o, p in zip(out, _plain(*args)):
        np.testing.assert_array_equal(o, p)
    for key, want in expect.items():
        got = {"depth": out[1], **internals}[key][0]
        assert got == want, (key, got, want)


# ---------------------------------------------------- (a) match vs JAX


def test_stereo_match_equals_jax_exactly():
    """The whole row match on features the JAX frontend extracted from a
    rendered pair (the integer images of the main path): u_right, depth
    and SAD exactly equal to the JAX package's, matched or not."""
    from synthetic import CylinderScene, circle_trajectory

    fx = 220.0
    K = np.array([[fx, 0, 192], [0, fx, 64], [0, 0, 1]])
    scene = CylinderScene(K, 128, 384, radius=8.0, tex_h=2048)
    T = circle_trajectory(4, orbit_r=3.0)[1]
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -0.5
    imgs = [scene.render(T).astype(np.uint8),
            scene.render(Trl @ T).astype(np.uint8)]
    fl, fr = [jfrontend.extract(jnp.asarray(im), n_features=400)
              for im in imgs]
    sf = (1.2 ** np.arange(8)).astype(f32)
    bf = 0.5 * fx
    lv = [im.astype(f32) for im in imgs]
    ref = jstereo.match(fl.xy, fl.octave, fl.desc, fl.valid,
                        fr.xy, fr.octave, fr.desc, fr.valid,
                        jnp.asarray(lv[0]), jnp.asarray(lv[1]),
                        jnp.asarray(sf), jnp.float32(bf), 0.0, jnp.float32(fx))

    def tt(a):
        a = np.asarray(a)
        return _t(a.view(np.int32) if a.dtype == np.uint32 else a)

    args = (tt(fl.xy), tt(fl.octave), tt(fl.desc), tt(fl.valid),
            tt(fr.xy), tt(fr.octave), tt(fr.desc), tt(fr.valid),
            _t(lv[0]), _t(lv[1]), _t(sf), bf, 0.0, fx)
    out = stereo.match(*args)
    assert int((np.asarray(ref.depth) > 0).sum()) > 50
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    for o, p in zip(out, stereo.match(*args, plain=True)):
        assert torch.equal(o, p)


# -------------------------------------------------------- (c) wrappers


def _refine_args(device):
    img = torch.zeros((32, 64), dtype=torch.float32, device=device)
    xy = torch.full((4, 2), 20.0, dtype=torch.float32, device=device)
    idx = torch.zeros(4, dtype=torch.int64, device=device)
    dist = torch.zeros(4, dtype=torch.int32, device=device)
    s = torch.zeros((), dtype=torch.float32, device=device)
    return img, img, xy, xy, idx, dist, s, s, s


def test_refine_cuda_refuses_cpu_and_refine_never_falls_back():
    with pytest.raises(ValueError, match="CUDA tensor"):
        stereo_cuda.refine_cuda(*_refine_args("cpu"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        stereo_cuda.refine(*_refine_args("meta"))
    assert cuda_build.library.cache_info().currsize == 0


def test_refine_on_cpu_is_the_plain_version_and_launches_nothing():
    stereo_cuda.launches = stereo_cuda.strips_launches = 0
    args = _refine_args("cpu")
    out = stereo_cuda.refine(*args)
    for o, p in zip(out, stereo_cuda.refine_plain(*args)):
        assert torch.equal(o, p)
    assert (stereo_cuda.launches, stereo_cuda.strips_launches) == (0, 0)
    assert cuda_build.library.cache_info().currsize == 0
