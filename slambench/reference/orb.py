"""A frozen plain copy of the ORB frontend the benchmark judges.

ORB-SLAM2's frame construction (ORBextractor::operator() and
Frame::ComputeStereoMatches / ComputeStereoFromRGBD) in plain PyTorch,
written once and kept here so that no change to the program under test
can move it: the image pyramid (cv::resize INTER_LINEAR), FAST-9 with
the per-cell threshold fallback and a 3x3 non-maximum suppression, the
grid top-K, the intensity-centroid angle (float64 moments), the 7x7
Gaussian blur, rBRIEF, and the stereo row search with the 11x11 SAD
parabola and the median-SAD sweep.  Every step follows the same
operations in the same order as the program's plain path, so on one
device the two give the same bits.

`lowp` is the control: the pyramid's levels rounded to bfloat16, the
precision step below float32 that a faster frontend would tempt.
Imports torch and numpy only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference.orb_pattern import BIT_PATTERN_31

EDGE_THRESHOLD = 19          # ORBextractor.cc:74
FAST_CELL = 30               # the per-cell threshold fallback
GRID_CELL = 24               # the grid top-K
PER_CELL = 4
HALF_PATCH = 15
DEG = float(np.float32(180.0 / np.pi))
RAD = float(np.float32(np.pi / 180.0))
MAX_DIST = 256
TH_LOW, TH_HIGH = 50, 100    # ORBmatcher.cc:37-38
TH_ORB = (TH_HIGH + TH_LOW) // 2
SAD_W = 5                    # SAD half-window (Frame.cc:557)
SAD_L = 5                    # search range (Frame.cc:563)
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _scalar(v, dev) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=dev)


# ---- pyramid -------------------------------------------------------------
def level_budgets(n_features: int, n_levels: int, scale: float) -> list:
    factor = 1.0 / scale
    n_first = n_features * (1 - factor) / (1 - factor ** n_levels)
    out, acc = [], 0
    for lv in range(n_levels - 1):
        b = int(round(n_first * factor ** lv))
        out.append(b)
        acc += b
    out.append(max(n_features - acc, 0))
    return out


def padded_total(n_features: int, n_levels: int, scale: float) -> int:
    return -(-sum(level_budgets(n_features, n_levels, scale)) // 128) * 128


def level_sizes(h: int, w: int, n_levels: int, scale: float) -> list:
    return [(int(np.rint(h / scale ** lv)), int(np.rint(w / scale ** lv)))
            for lv in range(n_levels)]


def _fma(a, b, c):
    """float32 a * b + c rounded once (the product is exact in float64)."""
    b = b.double() if torch.is_tensor(b) else float(np.float32(b))
    return (a.double() * b + c.double()).float()


def _coords(n_out: int, n_in: int, dev):
    i = torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5
    c = _fma(i, n_in / n_out, torch.full_like(i, -0.5))
    return c.clamp(0.0, n_in - 1.0)


def resize(img, out_h: int, out_w: int):
    in_h, in_w = img.shape
    ys, xs = _coords(out_h, in_h, img.device), _coords(out_w, in_w, img.device)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[:, None], (xs - x0)[None, :]
    y0i, x0i = y0.long(), x0.long()
    y1i = (y0i + 1).clamp(max=in_h - 1)
    x1i = (x0i + 1).clamp(max=in_w - 1)
    f = img.float()
    rows = _fma(f[y0i, :], 1.0 - wy, f[y1i, :] * wy)
    return _fma(rows[:, x0i], 1.0 - wx, rows[:, x1i] * wx)


def pyramid(img, n_levels: int, scale: float, lowp: bool = False) -> list:
    sizes = level_sizes(*img.shape, n_levels, scale)
    levels = [img.float()]
    for lv in range(1, n_levels):
        levels.append(resize(levels[-1], *sizes[lv]))
    if lowp:
        levels = [lv.bfloat16().float() for lv in levels]
    return levels


def _gauss7() -> list:
    x = np.arange(7, dtype=np.float64) - 3.0
    k = np.exp(-(x * x) / 8.0)
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


_K7 = _gauss7()


def blur7x7(img):
    """cv::GaussianBlur(7x7, sigma 2, BORDER_REFLECT_101)."""
    h, w = img.shape
    p = F.pad(img[None, None], (0, 0, 3, 3), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(7):
        out = out + _K7[i] * p[i:i + h, :]
    p2 = F.pad(out[None, None], (3, 3, 0, 0), mode="reflect")[0, 0]
    out2 = torch.zeros_like(img)
    for i in range(7):
        out2 = out2 + _K7[i] * p2[:, i:i + w]
    return out2


# ---- FAST ----------------------------------------------------------------
def ring(img):
    """(H, W) -> (16, H, W): the radius-3 circle's values, edge-clamped."""
    h, w = img.shape
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    return torch.stack([pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                        for dy, dx in CIRCLE], 0)


def raw_score(img):
    """OpenCV's FAST-9 score: the best 9-arc's least difference, minus 1."""
    f = img.float()
    diff = ring(f) - f[None]

    def arcs(d):
        m2 = torch.minimum(d, torch.roll(d, -1, 0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, 0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, 0))
        return torch.minimum(m8, torch.roll(d, -8, 0)).amax(0)

    return torch.maximum(arcs(-diff), arcs(diff)) - 1.0


def nms3x3(score):
    h, w = score.shape
    pad = F.pad(score, (1, 1, 1, 1))

    def sh(dy, dx):
        return pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    earlier = torch.maximum(torch.maximum(sh(-1, -1), sh(-1, 0)),
                            torch.maximum(sh(-1, 1), sh(0, -1)))
    later = torch.maximum(torch.maximum(sh(0, 1), sh(1, -1)),
                          torch.maximum(sh(1, 0), sh(1, 1)))
    keep = (score > earlier) & (score >= later) & (score > 0)
    return torch.where(keep, score, torch.zeros_like(score))


def detect(img, ini_th: float, min_th: float, border: int,
           cell: int = FAST_CELL):
    """NMS'd scores: per cell the high-threshold corners, else the low."""
    s = raw_score(img)
    lo = nms3x3(torch.where(s >= min_th, s, torch.zeros_like(s)))
    zero = torch.zeros_like(lo)
    hi = torch.where(lo >= ini_th, lo, zero)
    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inside = (yy >= border) & (yy < h - border) & (xx >= border) & \
        (xx < w - border)
    hi = torch.where(inside, hi, zero)
    lo = torch.where(inside, lo, zero)
    ch, cw = -(-h // cell), -(-w // cell)
    hp = F.pad(hi, (0, cw * cell - w, 0, ch * cell - h))
    has = hp.reshape(ch, cell, cw, cell).amax(dim=(1, 3)) > 0
    per_px = has[:, None, :, None].expand(ch, cell, cw, cell).reshape(
        ch * cell, cw * cell)[:h, :w]
    return torch.where(per_px, hi, lo)


def select_grid(score, n_keypoints: int, cell: int = GRID_CELL,
                per_cell: int = PER_CELL):
    """The best `per_cell` of each cell, then the global top n (a stable
    descending sort: ties to the lower index).  (xy int32, resp, valid)."""
    h, w = score.shape
    dev = score.device
    ch, cw = -(-h // cell), -(-w // cell)
    pad = F.pad(score, (0, cw * cell - w, 0, ch * cell - h))
    cur = pad.reshape(ch, cell, cw, cell).permute(0, 2, 1, 3).reshape(
        ch * cw, cell * cell)
    c_idx = torch.arange(ch * cw, device=dev)
    base_y, base_x = (c_idx // cw) * cell, (c_idx % cw) * cell
    lane = torch.arange(cell * cell, device=dev)[None, :]
    vals, xys = [], []
    for _ in range(per_cell):
        idx = torch.argmax(cur, dim=1)
        vals.append(torch.gather(cur, 1, idx[:, None])[:, 0])
        xys.append(torch.stack([base_x + idx % cell, base_y + idx // cell],
                               -1))
        cur = torch.where(lane == idx[:, None], torch.zeros_like(cur), cur)
    scores, xy = torch.cat(vals), torch.cat(xys)
    k = min(n_keypoints, scores.shape[0])
    top_val, top_idx = torch.sort(scores, descending=True, stable=True)
    top_val, top_xy = top_val[:k], xy[top_idx[:k]]
    valid = top_val > 0.0
    if k < n_keypoints:
        padn = n_keypoints - k
        top_val = torch.cat([top_val, top_val.new_zeros(padn)])
        top_xy = torch.cat([top_xy, top_xy.new_zeros((padn, 2))])
        valid = torch.cat([valid, valid.new_zeros(padn)])
    return top_xy.int(), top_val, valid


# ---- orientation and rBRIEF -----------------------------------------------
def _umax() -> np.ndarray:
    umax = np.zeros(HALF_PATCH + 1, np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(HALF_PATCH ** 2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def circular_mask() -> np.ndarray:
    umax = _umax()
    mask = np.zeros((31, 31), np.float32)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        u = umax[abs(v)]
        mask[v + HALF_PATCH, HALF_PATCH - u:HALF_PATCH + u + 1] = 1.0
    return mask


_MASK = circular_mask()
_DX = (np.arange(31) - HALF_PATCH).astype(np.float32)
_W10 = _MASK.astype(np.float64) * _DX[None, :]
_W01 = _MASK.astype(np.float64) * _DX[:, None]


def ic_angles(img, xy, valid, moments=torch.float64):
    """Intensity-centroid angles in degrees [0, 360) at integer keypoints;
    the moments in `moments` (float64 as the configuration states)."""
    h, w = img.shape
    dev = img.device
    x = xy[:, 0].long().clamp(HALF_PATCH, w - 1 - HALF_PATCH)
    y = xy[:, 1].long().clamp(HALF_PATCH, h - 1 - HALF_PATCH)
    d = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=dev)
    rows, cols = y[:, None] + d[None, :], x[:, None] + d[None, :]
    patches = img[rows[:, :, None], cols[:, None, :]].to(moments)
    w10 = torch.as_tensor(_W10, dtype=moments, device=dev)
    w01 = torch.as_tensor(_W01, dtype=moments, device=dev)
    m10 = (patches * w10).sum((1, 2)).float()
    m01 = (patches * w01).sum((1, 2)).float()
    ang = torch.atan2(m01, m10) * DEG
    ang = torch.where(ang < 0, ang + 360.0, ang)
    return torch.where(valid, ang, torch.zeros_like(ang))


def tap_coords(h: int, w: int, xy, angles_deg):
    """The 512 rotated taps of each keypoint, each clipped to the level."""
    pat = torch.as_tensor(BIT_PATTERN_31, dtype=torch.float32,
                          device=xy.device)
    px = torch.cat([pat[:, 0], pat[:, 2]])[None]
    py = torch.cat([pat[:, 1], pat[:, 3]])[None]
    rad = angles_deg * RAD
    a, b = torch.cos(rad)[:, None], torch.sin(rad)[:, None]
    rx = torch.round(px * a - py * b).long()
    ry = torch.round(px * b + py * a).long()
    rows = (xy[:, 1:2].long() + ry).clamp(0, h - 1)
    cols = (xy[:, 0:1].long() + rx).clamp(0, w - 1)
    return rows, cols


def pack_bits(bits):
    n = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(n, 8, 32).long() << shifts).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.int()


def describe(blurred, xy, angles_deg, valid):
    h, w = blurred.shape
    rows, cols = tap_coords(h, w, xy, angles_deg)
    taps = blurred.reshape(-1)[rows * w + cols]
    packed = pack_bits(taps[:, :256] < taps[:, 256:])
    return torch.where(valid[:, None], packed, torch.zeros_like(packed))


# ---- extraction -----------------------------------------------------------
def extract(img, n_features: int, n_levels: int, scale: float, ini_th: int,
            min_th: int, lowp: bool = False) -> dict:
    """One image's ORB features, padded to padded_total rows: xy (level-0
    float32), octave, angle, desc (int32 words), valid; and the levels and
    the per-level picks the kernel bounds read."""
    levels = pyramid(img, n_levels, scale, lowp)
    budgets = level_budgets(n_features, n_levels, scale)
    n_total = padded_total(n_features, n_levels, scale)
    border = EDGE_THRESHOLD - 3
    picks = [select_grid(detect(lv, ini_th, min_th, border), b)
             for lv, b in zip(levels, budgets)]
    xys = [p[0] for p in picks]
    valids = [p[2] for p in picks]
    angs, descs = [], []
    for lv, xy, v in zip(levels, xys, valids):
        ang = ic_angles(lv, xy, v)
        angs.append(ang)
        descs.append(describe(blur7x7(lv), xy, ang, v))
    scales = [float(np.float32(scale ** lv)) for lv in range(n_levels)]
    dev = img.device
    out = {
        "xy": torch.cat([xy.float() * s for xy, s in zip(xys, scales)]),
        "octave": torch.cat([torch.full((b,), lv, dtype=torch.int32,
                                        device=dev)
                             for lv, b in enumerate(budgets)]),
        "angle": torch.cat(angs),
        "desc": torch.cat(descs),
        "valid": torch.cat(valids),
    }
    pad = n_total - out["xy"].shape[0]
    if pad > 0:
        out = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
               for k, v in out.items()}
    out["levels"], out["xys"], out["valids"] = levels, xys, valids
    return out


# ---- stereo -----------------------------------------------------------------
def _popcount32(x):
    v = x.long() & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_matrix(a, b):
    """(N, 8) x (M, 8) int32 words -> (N, M) int32 Hamming distances."""
    return _popcount32(a[:, None, :] ^ b[None, :, :]).sum(-1).int()


def row_matches(fl: dict, fr: dict, scale_factors, min_disp, max_disp):
    """Each left keypoint's best right one by Hamming distance in its row
    band, octave band and disparity window (first minimum on ties)."""
    r_band = 2.0 * scale_factors[fr["octave"].long()][None, :]
    row_ok = torch.abs(fl["xy"][:, 1:2] - fr["xy"][None, :, 1]) <= r_band
    ol, orr = fl["octave"][:, None], fr["octave"][None, :]
    oct_ok = (orr >= ol - 1) & (orr <= ol + 1)
    disp = fl["xy"][:, 0:1] - fr["xy"][None, :, 0]
    disp_ok = (disp >= min_disp) & (disp <= max_disp)
    mask = (row_ok & oct_ok & disp_ok & fl["valid"][:, None]
            & fr["valid"][None, :])
    d = torch.where(mask, hamming_matrix(fl["desc"], fr["desc"]),
                    torch.full((), MAX_DIST, dtype=torch.int32,
                               device=mask.device))
    best_idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, best_idx[:, None])[:, 0]
    return best_idx, best


def centres(xy_l, xy_r, best_idx, h: int, w: int):
    yc = xy_l[:, 1].int().clamp(SAD_W, h - 1 - SAD_W)
    xl = xy_l[:, 0].int().clamp(SAD_W + SAD_L, w - 1 - SAD_W - SAD_L)
    xr = xy_r[best_idx, 0].int().clamp(SAD_W + SAD_L, w - 1 - SAD_W - SAD_L)
    return yc, xl, xr


def sad_scores(left, right, yc, xl, xr):
    """(N, 11) centre-normalised 11x11 SADs over the +/-5 px search."""
    dev = left.device
    d = torch.arange(-SAD_W, SAD_W + 1, device=dev)
    rows = yc.long()[:, None] + d[None, :]
    patch = left[rows[:, :, None], (xl.long()[:, None] + d[None, :])[:, None]]
    dr = torch.arange(-SAD_W - SAD_L, SAD_W + SAD_L + 1, device=dev)
    strip = right[rows[:, :, None], (xr.long()[:, None] + dr[None, :])[:, None]]
    patch_n = patch - patch[:, SAD_W, SAD_W][:, None, None]
    sads = []
    for s in range(2 * SAD_L + 1):
        win = strip[:, :, s:s + 2 * SAD_W + 1]
        sads.append(torch.abs(patch_n - (win - win[:, SAD_W, SAD_W][:, None,
                                                                    None])
                              ).sum((1, 2)))
    return torch.stack(sads, 1)


def refine(scores, u_l, xr, best_dist, bf, min_disp, max_disp):
    """The parabola over the best shift, the disparity window and depth:
    (u_right, depth, sad), -1 / -1 / inf where the match is not good."""
    n = scores.shape[0]
    best_s = torch.argmin(scores, dim=1)
    best_sad = scores.amin(dim=1)
    interior = (best_s > 0) & (best_s < 2 * SAD_L)
    rows = torch.arange(n, device=scores.device)
    im1 = scores[rows, (best_s - 1).clamp(min=0)]
    ip1 = scores[rows, (best_s + 1).clamp(max=2 * SAD_L)]
    denom = im1 + ip1 - 2.0 * best_sad
    delta = torch.where(interior & (denom > 1e-6),
                        0.5 * (im1 - ip1) / denom.clamp(min=1e-6),
                        torch.zeros_like(denom)).clamp(-1.0, 1.0)
    u_right = xr.float() + (best_s - SAD_L).float() + delta
    disparity = u_l - u_right
    good = (best_dist < TH_ORB) & (disparity >= min_disp) & \
        (disparity < max_disp)
    disparity = torch.where(disparity <= 0, _scalar(0.01, scores.device),
                            disparity)
    neg = torch.full_like(disparity, -1.0)
    return (torch.where(good, u_right, neg),
            torch.where(good, bf / disparity, neg),
            torch.where(good, best_sad, torch.full_like(best_sad, torch.inf)))


def median_sad_sweep(u_right, depth, sad):
    """Drop matches with SAD > 1.5 * 1.4 * the median (Frame.cc:626-639);
    the median of an even count is the mean of the two middle values."""
    finite = torch.isfinite(sad)
    srt = torch.sort(torch.where(finite, sad,
                                 torch.full_like(sad, torch.inf)))[0]
    cnt = int(finite.sum())
    if cnt == 0:
        keep = finite
    else:
        med = srt[(cnt - 1) // 2] * 0.5 + srt[cnt // 2] * 0.5
        keep = finite & (sad <= 1.5 * 1.4 * med)
    neg = torch.full_like(u_right, -1.0)
    return torch.where(keep, u_right, neg), torch.where(keep, depth, neg)


def stereo_frame(img_l, img_r, s: dict, lowp: bool = False) -> dict:
    """A stereo frame's left features with u_right and depth, and what the
    kernel bounds read (levels, picks, the SAD centres)."""
    args = (s["n_features"], s["n_levels"], s["scale"], s["ini_th"],
            s["min_th"], lowp)
    fl, fr = extract(img_l, *args), extract(img_r, *args)
    dev = img_l.device
    sf = torch.as_tensor(np.asarray(
        s["scale"] ** np.arange(s["n_levels"]), np.float32), device=dev)
    bf, lo, hi = (_scalar(v, dev) for v in (s["bf"], 0.0, s["fx"]))
    best_idx, best_dist = row_matches(fl, fr, sf, lo, hi)
    left, right = fl["levels"][0], fr["levels"][0]
    h, w = left.shape
    yc, xl, xr = centres(fl["xy"], fr["xy"], best_idx, h, w)
    ur, depth, sad = refine(sad_scores(left, right, yc, xl, xr),
                            fl["xy"][:, 0], xr, best_dist, bf, lo, hi)
    fl["ur"], fl["depth"] = median_sad_sweep(ur, depth, sad)
    fl["centres"] = (yc, xl, xr)
    fl["right"] = fr
    return fl


def rgbd_frame(img, depth_img, s: dict, lowp: bool = False) -> dict:
    """An RGB-D frame's features with the depth read at each keypoint and
    the synthetic right coordinate u - bf / d (Frame.cc:643-664)."""
    f = extract(img, s["n_features"], s["n_levels"], s["scale"],
                s["ini_th"], s["min_th"], lowp)
    h, w = depth_img.shape
    xi = torch.round(f["xy"][:, 0]).long().clamp(0, w - 1)
    yi = torch.round(f["xy"][:, 1]).long().clamp(0, h - 1)
    d = depth_img[yi, xi].float() * (1.0 / s["depth_map_factor"])
    good = f["valid"] & (d > 0)
    neg = torch.full_like(d, -1.0)
    f["depth"] = torch.where(good, d, neg)
    f["ur"] = torch.where(
        good, f["xy"][:, 0] - _scalar(s["bf"], d.device) / d.clamp(min=1e-6),
        neg)
    return f
