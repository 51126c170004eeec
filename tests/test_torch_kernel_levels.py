"""The one-launch-per-image FAST and describe kernels, held on the CPU.

The kernels (csrc/fast.cu, csrc/orb.cu) run only on the card, where
chip_smoke.py holds them against their plain versions.  These tests hold
what surrounds them and what they compute, without a card:

  1. the level tables the wrappers build cover every 30-px cell and every
     keypoint row exactly once, in order, under the kernels' own lookup
     (transcribed below);
  2. the multi-level plain entry points equal the JAX package's per-level
     functions, level by level;
  3. numpy transcriptions of the kernels' per-pixel and per-cell FAST
     steps and of the describe kernel's staged tap window equal the plain
     versions exactly;
  4. the float64 circle moments are the same in every summation order on
     the levels of a rendered KITTI-shaped frame;
  5. frontend.extract, now one FAST call and one describe call over all
     levels, gives the Features of the former per-level loop;
plus System's device default.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.ops import brief as jbrief
from orb_slam2_tpu.ops import fast as jfast
from orb_slam2_tpu.ops import fast_pallas as jfast_pallas
from orb_slam2_tpu.ops import orientation as jorientation
from orb_slam2_tpu.ops import pyramid as jpyramid
from orb_slam2_tpu_torch.config import Sensor, Settings
from orb_slam2_tpu_torch.ops import (
    brief, fast, fast_cuda, frontend, gaussian, orb_cuda, orientation,
    pyramid,
)
from orb_slam2_tpu_torch.system import System

torch.set_num_threads(2)

BORDER = frontend.EDGE_THRESHOLD - 3
SHAPES = [(376, 1240), (128, 384), (97, 131)]
KITTI_K = np.array([[718.856, 0, 607.19], [0, 718.856, 185.22], [0, 0, 1]])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rendered(h: int, w: int, K=None) -> np.ndarray:
    from synthetic import CylinderScene, circle_trajectory

    if K is None:
        K = np.array([[220.0, 0, w / 2], [0, 220.0, h / 2], [0, 0, 1]])
    scene = CylinderScene(K, h, w, radius=8.0, tex_h=2048)
    T = circle_trajectory(4, orbit_r=3.0)[1]
    return scene.render(T).astype(np.uint8).astype(np.float32)


def _blocks() -> np.ndarray:
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 255, (200, 300)).astype(np.float32)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    img[40:80, 40:90] = 10.0
    img[120:160, 150:260] = 240.0
    return np.rint(img).astype(np.float32)


def _levels(img: np.ndarray, n_levels: int = 8):
    return pyramid.compute_pyramid(_t(img), n_levels, 1.2)


def _picks(levels, n_features: int):
    budgets = frontend.level_budgets(n_features, len(levels), 1.2)
    scores = fast_cuda.detect_levels_plain(levels, 20, 7, BORDER)
    return [fast.select_topk_grid(s, b, 24) for s, b in zip(scores, budgets)]


# ------------------------------------------------------- 1. level tables


def _fast_block(table, b):
    """csrc/fast.cu find_level and cell index, transcribed: the last level
    whose first cell is <= b, then the cell's row and column there."""
    level = 0
    for i in range(1, len(table)):
        if b >= table[i][3]:
            level = i
    _, _, cells_x, cell0 = table[level]
    local = b - cell0
    return level, local // cells_x, local - (local // cells_x) * cells_x


def _describe_row(table, row):
    """csrc/orb.cu find_level, transcribed: the level holding `row`, or -1
    for a padding row; and the keypoint's index in its level."""
    found, kp = -1, -1
    for i, (row0, count) in enumerate(table):
        if row0 <= row < row0 + count:
            found, kp = i, row - row0
    return found, kp


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cell", [30, 17])
def test_fast_cell_table_covers_every_cell_once_in_order(shape, cell):
    sizes = pyramid.level_sizes(*shape, 8, 1.2)
    table, n_cells = fast_cuda.cell_table(sizes, cell)
    expect = [(l, cy, cx) for l, (h, w) in enumerate(sizes)
              for cy in range(-(-h // cell)) for cx in range(-(-w // cell))]
    got = [_fast_block(table, b) for b in range(n_cells)]
    assert got == expect
    assert [row[:2] for row in table] == [tuple(s) for s in sizes]
    if shape == (376, 1240) and cell == 30:
        assert n_cells == 1744


@pytest.mark.parametrize("shape", SHAPES)
def test_describe_row_table_covers_every_row_once_in_order(shape):
    for n_features in (2000, 1000, 200):
        budgets = frontend.level_budgets(n_features, 8, 1.2)
        n_rows = frontend.padded_total(n_features, 8, 1.2)
        table = orb_cuda.row_table(budgets, n_rows)
        expect = [(l, k) for l, b in enumerate(budgets) for k in range(b)]
        expect += [(-1, -1)] * (n_rows - len(expect))
        assert [_describe_row(table, r) for r in range(n_rows)] == expect
    with pytest.raises(ValueError, match="do not fit"):
        orb_cuda.row_table([100, 100], 150)


# ------------------------------------- 2. multi-level plain against JAX


@pytest.mark.parametrize("kind", ["scene", "kitti"])
def test_detect_levels_plain_equals_jax_per_level(kind):
    """Exact, level by level, against the XLA path; against the Pallas
    kernel in interpret mode too on the small image."""
    img = {"blocks": _blocks, "scene": lambda: _rendered(128, 384),
           "kitti": lambda: _rendered(376, 1240, KITTI_K)}[kind]()
    jlevels = jpyramid.compute_pyramid(jnp.asarray(img), 8, 1.2)
    levels = [_t(np.asarray(lv)) for lv in jlevels]
    out = fast_cuda.detect_levels_plain(levels, 20, 7, BORDER)
    via_dispatch = fast_cuda.detect_levels(levels, 20, 7, BORDER)
    assert len(out) == 8
    for l, (jl, o, d) in enumerate(zip(jlevels, out, via_dispatch)):
        ref = np.asarray(jfast.detect_with_fallback(jl, 20, 7, BORDER))
        np.testing.assert_array_equal(o.numpy(), ref, err_msg=f"level {l}")
        assert torch.equal(o, d)
        if kind != "kitti":
            ref_pallas = np.asarray(jfast_pallas.detect_with_fallback(
                jl, 20.0, 7.0, BORDER, interpret=True))
            np.testing.assert_array_equal(o.numpy(), ref_pallas,
                                          err_msg=f"level {l}")
    assert sum(int((o > 0).sum()) for o in out) > 100


@pytest.mark.parametrize("kind", ["blocks", "kitti"])
def test_describe_levels_plain_equals_jax_per_level(kind):
    """Angles within 1e-3 deg of JAX's float32 moments, and descriptors
    identical to JAX's describe at the same angles on >= 99% of valid
    keypoints per level: the tolerances of tests/test_torch_ops.py, for
    the same reasons.  (Each package's descriptors at its own angles can
    differ more on a level of a few dozen keypoints: a 1e-5 deg angle
    difference moves a tap that sits at .5.)  The padding rows are
    zero."""
    img = {"blocks": _blocks, "scene": lambda: _rendered(128, 384),
           "kitti": lambda: _rendered(376, 1240, KITTI_K)}[kind]()
    n_features = 2000 if kind == "kitti" else 500
    levels = _levels(img)
    picks = _picks(levels, n_features)
    blurs = [gaussian.blur7x7(lv) for lv in levels]
    xys, _, valids = zip(*picks)
    n_rows = frontend.padded_total(n_features, 8, 1.2)
    ang, desc = orb_cuda.describe_levels_plain(levels, blurs, xys, valids,
                                               n_rows)
    assert ang.shape == (n_rows,) and desc.shape == (n_rows, 8)
    row = 0
    for l, (lv, bl, xy, valid) in enumerate(zip(levels, blurs, xys, valids)):
        n = xy.shape[0]
        jl, jxy, jv = (jnp.asarray(lv.numpy()), jnp.asarray(xy.numpy()),
                       jnp.asarray(valid.numpy()))
        jang = jorientation.ic_angles(jl, jxy, jv)
        a = ang[row:row + n].numpy()
        jdesc = np.asarray(jbrief.describe(jnp.asarray(bl.numpy()), jxy,
                                           jnp.asarray(a), jv))
        d = np.abs(a - np.asarray(jang))
        assert np.minimum(d, 360.0 - d).max() <= 1e-3, (l, d.max())
        v = valid.numpy()
        same = (desc[row:row + n].numpy().view(np.uint32) == jdesc).all(1)
        assert same[v].mean() >= 0.99, (l, same[v].mean())
        row += n
    assert row == sum(frontend.level_budgets(n_features, 8, 1.2))
    assert (ang[row:] == 0).all() and (desc[row:] == 0).all()
    via_dispatch = orb_cuda.describe_levels(levels, blurs, xys, valids,
                                            n_rows)
    assert torch.equal(via_dispatch[0], ang)
    assert torch.equal(via_dispatch[1], desc)


# ---------------------------------- 3. the kernels' steps, transcribed


def _ring_np(img: np.ndarray) -> np.ndarray:
    h, w = img.shape
    pad = np.pad(img, 3, mode="edge")
    return np.stack([pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                     for dy, dx in fast.CIRCLE])


def _kernel_score_np(tile_ring: np.ndarray, center: np.ndarray,
                     min_th: float, early_exit: bool) -> np.ndarray:
    """csrc/fast.cu arc_score, transcribed in float32 over an array of
    pixels: tile_ring (16, ...) the ring's values, center (...)."""
    f32 = np.float32
    d = (tile_ring - center[None]).astype(f32)
    nxt = lambda a, s: np.roll(a, -s, axis=0)      # a[(k + s) & 15]
    mn2, mx2 = np.minimum(d, nxt(d, 1)), np.maximum(d, nxt(d, 1))
    mn4, mx4 = np.minimum(mn2, nxt(mn2, 2)), np.maximum(mx2, nxt(mx2, 2))
    mn9 = np.minimum(np.minimum(mn4, nxt(mn4, 4)), nxt(d, 8))
    mx9 = np.maximum(np.maximum(mx4, nxt(mx4, 4)), nxt(d, 8))
    raw = (np.maximum(-mx9.min(0), mn9.max(0)) - f32(1.0)).astype(f32)
    score = np.where(raw >= f32(min_th), raw, f32(0.0))
    if early_exit:
        c = d[[0, 4, 8, 12]]
        cn = np.roll(c, -1, axis=0)
        dark = np.minimum(c, cn).max(0)
        bright = -np.maximum(c, cn).min(0)
        passes = (np.maximum(dark, bright) - f32(1.0)).astype(f32) >= min_th
        score = np.where(passes, score, f32(0.0))
    return score.astype(f32)


def _kernel_detect_levels_np(levels, ini_th, min_th, border, cell,
                             early_exit):
    """csrc/fast.cu fast_levels_kernel, transcribed block by block: the
    staged edge-clamped tile, the score tile with 0 outside the image, the
    NMS with the raster tie-break, the border mask and the cell's
    fallback."""
    f32 = np.float32
    table, n_cells = fast_cuda.cell_table([lv.shape for lv in levels], cell)
    outs = [np.full(lv.shape, np.nan, f32) for lv in levels]
    halo = 4
    tdim, sdim = cell + 2 * halo, cell + 2
    for b in range(n_cells):
        level, cy, cx = _fast_block(table, b)
        img, out = levels[level], outs[level]
        h, w = img.shape
        y0, x0 = cy * cell, cx * cell
        rr = np.clip(np.arange(tdim) + y0 - halo, 0, h - 1)
        cc = np.clip(np.arange(tdim) + x0 - halo, 0, w - 1)
        tile = img[rr[:, None], cc[None, :]]
        sy, sx = np.meshgrid(np.arange(sdim), np.arange(sdim), indexing="ij")
        ring = np.stack([tile[sy + halo - 1 + dy, sx + halo - 1 + dx]
                         for dy, dx in fast.CIRCLE])
        s = _kernel_score_np(ring, tile[sy + halo - 1, sx + halo - 1],
                             min_th, early_exit)
        py, px = y0 - 1 + sy, x0 - 1 + sx
        s = np.where((py >= 0) & (py < h) & (px >= 0) & (px < w), s, f32(0))
        ny, nx = min(cell, h - y0), min(cell, w - x0)
        r, c = np.meshgrid(np.arange(ny) + 1, np.arange(nx) + 1,
                           indexing="ij")
        v = s[r, c]
        earlier = np.maximum(np.maximum(s[r - 1, c - 1], s[r - 1, c]),
                             np.maximum(s[r - 1, c + 1], s[r, c - 1]))
        later = np.maximum(np.maximum(s[r, c + 1], s[r + 1, c - 1]),
                           np.maximum(s[r + 1, c], s[r + 1, c + 1]))
        keep = (v > earlier) & (v >= later) & (v > 0)
        gy, gx = y0 + r - 1, x0 + c - 1
        inb = (gy >= border) & (gy < h - border) & (gx >= border) & \
            (gx < w - border)
        lo = np.where(keep & inb, v, f32(0))
        hi = np.where(lo >= ini_th, lo, f32(0))
        out[y0:y0 + ny, x0:x0 + nx] = hi if (hi > 0).any() else lo
    return outs


@pytest.mark.parametrize("kind", ["blocks", "scene", "odd"])
@pytest.mark.parametrize("early_exit", [False, True])
def test_kernel_score_transcription_equals_plain(kind, early_exit):
    """The doubling minima (and the compass early exit) per pixel give the
    plain thresholded score map exactly, at every level."""
    img = {"blocks": _blocks, "scene": lambda: _rendered(128, 384),
           "odd": lambda: np.random.default_rng(11).integers(
               0, 256, (97, 131)).astype(np.float32)}[kind]()
    n_exit = 0
    for lv in _levels(img, 4):
        a = lv.numpy()
        for th in (7.0, 20.0):
            got = _kernel_score_np(_ring_np(a), a, th, early_exit)
            ref = fast.fast_score_map(lv, th).numpy()
            np.testing.assert_array_equal(got, ref)
        n_exit += int((_kernel_score_np(_ring_np(a), a, 7.0, True) == 0)
                      .sum())
    assert n_exit > 0


@pytest.mark.parametrize("kind", ["blocks", "scene", "odd"])
def test_kernel_cells_transcription_equals_plain(kind):
    """The kernel's blocks, transcribed, give detect_with_fallback
    exactly at all 8 levels, with the early exit and without, at the
    30-px cell and at a 17-px one (partial cells at every edge)."""
    img = {"blocks": _blocks, "scene": lambda: _rendered(128, 384),
           "odd": lambda: np.random.default_rng(11).integers(
               0, 256, (97, 131)).astype(np.float32)}[kind]()
    levels = _levels(img)
    for cell, early_exit in ((30, False), (30, True), (17, True)):
        got = _kernel_detect_levels_np([lv.numpy() for lv in levels], 20.0,
                                       7.0, BORDER, cell, early_exit)
        ref = fast_cuda.detect_levels_plain(levels, 20, 7, BORDER, cell)
        for l, (g, r) in enumerate(zip(got, ref)):
            np.testing.assert_array_equal(g, r.numpy(),
                                          err_msg=f"level {l} cell {cell}")


def test_staged_tap_window_equals_clipped_taps():
    """csrc/orb.cu's 39x39 window of `blur`, each row and column clamped to
    the level, read at (ry + 19, rx + 19), gives brief.describe's
    per-tap-clipped descriptors bit for bit, at keypoints on and near all
    four edges and every angle step; and the ORB pattern stays inside it."""
    reach = orb_cuda.TAP_REACH
    pat = brief.get_pattern().astype(np.int64)
    assert np.maximum(pat[:, 0] ** 2 + pat[:, 1] ** 2,
                      pat[:, 2] ** 2 + pat[:, 3] ** 2).max() <= reach ** 2
    blur = gaussian.blur7x7(_t(_rendered(128, 384))).numpy()
    h, w = blur.shape
    rng = np.random.default_rng(3)
    xy = np.stack([rng.integers(0, w, 400), rng.integers(0, h, 400)], 1)
    xy[:8] = [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1],
              [3, 60], [w - 4, 60], [200, 2], [200, h - 3]]
    xy = xy.astype(np.int32)
    ang = np.linspace(0, 360, 400, endpoint=False).astype(np.float32)
    valid = np.ones(400, bool)
    ref = brief.describe(_t(blur), _t(xy), _t(ang), _t(valid)).numpy()

    rad = torch.from_numpy(ang) * orientation.RAD
    a, b = torch.cos(rad).numpy(), torch.sin(rad).numpy()
    f = pat.astype(np.float32)
    words = np.zeros((400, 8), np.uint32)
    for i, (kx, ky) in enumerate(xy):
        rows = np.clip(ky - reach + np.arange(2 * reach + 1), 0, h - 1)
        cols = np.clip(kx - reach + np.arange(2 * reach + 1), 0, w - 1)
        staged = blur[rows[:, None], cols[None, :]]
        rx0 = np.rint(f[:, 0] * a[i] - f[:, 1] * b[i]).astype(int)
        ry0 = np.rint(f[:, 0] * b[i] + f[:, 1] * a[i]).astype(int)
        rx1 = np.rint(f[:, 2] * a[i] - f[:, 3] * b[i]).astype(int)
        ry1 = np.rint(f[:, 2] * b[i] + f[:, 3] * a[i]).astype(int)
        bits = (staged[ry0 + reach, rx0 + reach]
                < staged[ry1 + reach, rx1 + reach])
        words[i] = (bits.reshape(8, 32).astype(np.uint64)
                    << np.arange(32, dtype=np.uint64)).sum(1)
    np.testing.assert_array_equal(words, ref.view(np.uint32))


# ------------------------------------------ 4. moments in every order


def _lane_order(terms: np.ndarray) -> np.ndarray:
    """csrc/orb.cu's order: lane j sums column j of the (n, 31, 31) terms
    over the rows in order, then the warp's xor-shuffle tree over 32
    lanes (lane 31 holds 0); the value every lane ends with."""
    lanes = np.zeros(terms.shape[:1] + (32,))
    lanes[:, :31] = np.cumsum(terms, axis=1)[:, -1, :]
    idx = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ off]
    assert (lanes == lanes[:, :1]).all()
    return lanes[:, 0]


def test_float64_moments_equal_in_every_order_on_kitti_levels():
    """The circle moments at the frontend's 2000-feature keypoints of all
    8 levels of a rendered 376x1240 frame, summed in row order, in the
    kernel's lane order, in a shuffled order, by the plain path's own
    reduction and correctly rounded (math.fsum):

    - bit-equal in float64 on every patch whose circle pixels are all 0
      or >= 2^-8 (each term u * p is then a multiple of 2^-31 below 2^22,
      so every partial sum is exact);
    - on the other patches (the resized levels of this frame hold pixels
      far below 2^-8, from the dark texture) the float64 sums may differ
      in the last bits, but the float32 moments the angle is taken from
      are equal in every order, and so are the angles.
    """
    levels = _levels(_rendered(376, 1240, KITTI_K))
    picks = _picks(levels, 2000)
    half = orientation.HALF_PATCH
    mask = orientation.circular_mask().astype(np.float64)
    du = np.arange(-half, half + 1, dtype=np.float64)
    rng = np.random.default_rng(7)
    n_checked = n_tiny = 0
    for lv, (xy, _, valid) in zip(levels, picks):
        img = lv.numpy()
        h, w = img.shape
        xy = xy.numpy()[valid.numpy()]
        cx = np.clip(xy[:, 0], half, w - 1 - half)
        cy = np.clip(xy[:, 1], half, h - 1 - half)
        d = np.arange(-half, half + 1)
        p = img[(cy[:, None] + d)[:, :, None],
                (cx[:, None] + d)[:, None, :]].astype(np.float64)
        tiny = ((p > 0) & (p < 2.0 ** -8) & (mask > 0)).any((1, 2))
        n_tiny += int(tiny.sum())
        pt = torch.from_numpy(p)
        plain10 = (pt * torch.from_numpy(orientation._W10)).sum((1, 2))
        plain01 = (pt * torch.from_numpy(orientation._W01)).sum((1, 2))
        for weights, plain in ((mask * du[None, :], plain10),
                               (mask * du[:, None], plain01)):
            terms = p * weights                          # (n, 31, 31)
            flat = terms.reshape(len(p), -1)
            row_order = np.cumsum(flat, axis=1)[:, -1]
            shuffled = np.cumsum(flat[:, rng.permutation(flat.shape[1])],
                                 axis=1)[:, -1]
            exact = np.array([math.fsum(t) for t in flat])
            for other in (_lane_order(terms), shuffled, plain.numpy(), exact):
                np.testing.assert_array_equal(row_order[~tiny], other[~tiny])
                np.testing.assert_array_equal(row_order.astype(np.float32),
                                              other.astype(np.float32))
        ang = orientation.ic_angles(lv, _t(xy), torch.ones(len(xy),
                                                           dtype=torch.bool))
        m10 = torch.from_numpy(_lane_order(p * mask * du[None, :])).float()
        m01 = torch.from_numpy(_lane_order(p * mask * du[:, None])).float()
        lane_ang = torch.atan2(m01, m10) * orientation.DEG
        lane_ang = torch.where(lane_ang < 0, lane_ang + 360.0, lane_ang)
        assert torch.equal(ang, lane_ang)
        n_checked += len(xy)
    assert n_checked > 1500
    assert 0 < n_tiny < n_checked


# ------------------------------------------------- 5. frontend.extract


def _extract_per_level(img, n_features, n_levels, scale_factor, ini_th,
                       min_th, cell):
    """frontend.extract as it was before the one-launch kernels: FAST,
    top-K, blur and describe level by level, then the concatenations."""
    levels = pyramid.compute_pyramid(img, n_levels, scale_factor)
    budgets = frontend.level_budgets(n_features, n_levels, scale_factor)
    n_total = frontend.padded_total(n_features, n_levels, scale_factor)
    outs = {"xy": [], "resp": [], "oct": [], "ang": [], "desc": [],
            "valid": []}
    for l, lvl in enumerate(levels):
        score = fast_cuda.detect_with_fallback(lvl, ini_th, min_th, BORDER)
        xy, resp, valid = fast.select_topk_grid(score, budgets[l], cell)
        ang, desc = orb_cuda.describe_oriented(lvl, gaussian.blur7x7(lvl),
                                               xy, valid)
        scale = float(np.float32(scale_factor ** l))
        outs["xy"].append(xy.float() * scale)
        outs["resp"].append(resp)
        outs["oct"].append(torch.full((budgets[l],), l, dtype=torch.int32))
        outs["ang"].append(ang)
        outs["desc"].append(desc)
        outs["valid"].append(valid)
    cat = {k: torch.cat(v) for k, v in outs.items()}
    pad = n_total - cat["xy"].shape[0]
    cat = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
           for k, v in cat.items()}
    return frontend.Features(cat["xy"], cat["resp"], cat["oct"], cat["ang"],
                             cat["desc"], cat["valid"])


@pytest.mark.parametrize("case", [("scene", 500, 8), ("blocks", 300, 8),
                                  ("scene", 300, 4)])
def test_extract_equals_former_per_level_loop(case):
    kind, n_features, n_levels = case
    img = _rendered(128, 384) if kind == "scene" else _blocks()
    u8 = _t(img.astype(np.uint8))
    before = _extract_per_level(u8, n_features, n_levels, 1.2, 20, 7, 24)
    for plain in (False, True):
        after = frontend.extract(u8, n_features, n_levels, 1.2, 20, 7, 24,
                                 plain=plain)
        for name, a, b in zip(frontend.Features._fields, after, before):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(before.valid.sum()) > 100


def test_extract_on_cpu_launches_no_kernel():
    fast_cuda.launches = orb_cuda.launches = 0
    frontend.extract(_t(_blocks()), 300)
    assert (fast_cuda.launches, orb_cuda.launches) == (0, 0)


# ------------------------------------------------------ System's device


def test_system_device_defaults_to_the_card():
    """Without `device`, System runs on the card: on a machine with no
    card it raises instead of carrying on on the CPU."""
    s = Settings(fx=260.0, fy=260.0, cx=160, cy=120, bf=31.2, width=320,
                 height=240, n_features=300)
    if torch.cuda.is_available():
        assert System(s, Sensor.STEREO).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            System(s, Sensor.STEREO)
    assert System(s, Sensor.STEREO, device="cpu").device.type == "cpu"
