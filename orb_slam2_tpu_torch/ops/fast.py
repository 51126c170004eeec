"""FAST-9/16 corner detection as a dense tensor op.

Port of orb_slam2_tpu/ops/fast.py: the dense equivalent of the per-cell
cv::FAST calls in ORBextractor::ComputeKeyPointsOctTree
(ref: src/ORBextractor.cc:765-853), with the reference's threshold
fallback (FAST(iniTh=20), retry FAST(minTh=7) in empty cells, ref
:809-816) computed from one score map.  These are the plain versions;
`fast_cuda.detect_with_fallback` is the Hopper kernel the frontend runs
on a CUDA tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 — the 16 segment-test offsets (dy, dx),
# standard FAST ordering starting at 12 o'clock going clockwise.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _ring(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (16, H, W) of circle-neighbor values (edge-clamped)."""
    h, w = img.shape
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    taps = [pad[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in CIRCLE]
    return torch.stack(taps, 0)


def raw_score_map(img: torch.Tensor) -> torch.Tensor:
    """Dense threshold-free FAST-9 corner score map.

    OpenCV's score: the largest threshold t for which the pixel passes the
    segment test, i.e. the max over the 16 contiguous 9-arcs of (min over
    the arc of the difference), for bright and dark arcs, minus 1.
    """
    f = img.float()
    diff = _ring(f) - f[None]            # neighbor minus center

    def arc_scores(d):
        # sliding minimum over 9 consecutive ring positions by doubling
        m2 = torch.minimum(d, torch.roll(d, -1, 0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, 0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, 0))
        m9 = torch.minimum(m8, torch.roll(d, -8, 0))
        return m9.amax(0)

    return torch.maximum(arc_scores(-diff), arc_scores(diff)) - 1.0


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9 corner score map; 0 where not a corner."""
    score = raw_score_map(img)
    return torch.where(score >= threshold, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression with a raster tie-break: a pixel is
    kept iff it is > its raster-earlier neighbors and >= its later ones
    (zero outside the image)."""
    h, w = score.shape
    pad = F.pad(score, (1, 1, 1, 1))

    def shift(dy, dx):
        return pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    earlier = torch.maximum(
        torch.maximum(shift(-1, -1), shift(-1, 0)),
        torch.maximum(shift(-1, 1), shift(0, -1)),
    )
    later = torch.maximum(
        torch.maximum(shift(0, 1), shift(1, -1)),
        torch.maximum(shift(1, 0), shift(1, 1)),
    )
    keep = (score > earlier) & (score >= later) & (score > 0)
    return torch.where(keep, score, torch.zeros_like(score))


def detect_with_fallback(
    img: torch.Tensor,
    ini_threshold: float,
    min_threshold: float,
    border: int,
    cell: int = 30,
) -> torch.Tensor:
    """Dense detection with the reference's per-cell threshold fallback.

    border: exclusion margin in pixels (ref uses EDGE_THRESHOLD-3 = 16).
    Returns an NMS'd score map, zero outside [border, size-border); in
    each `cell`-px cell, the high-threshold corners if there are any,
    else the low-threshold ones.
    """
    # NMS(hi) == NMS(lo) masked at the high threshold: any neighbor that
    # suppresses a pixel scores >= it, so one map serves both thresholds.
    lo = nms3x3(fast_score_map(img, min_threshold))
    zero = torch.zeros_like(lo)
    hi = torch.where(lo >= ini_threshold, lo, zero)

    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    valid = (
        (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    )
    hi = torch.where(valid, hi, zero)
    lo = torch.where(valid, lo, zero)

    # per-cell "did the high threshold fire?" map, broadcast back to pixels
    ch = -(-h // cell)
    cw = -(-w // cell)
    hi_pad = F.pad(hi, (0, cw * cell - w, 0, ch * cell - h))
    cell_has_hi = hi_pad.reshape(ch, cell, cw, cell).amax(dim=(1, 3)) > 0
    per_pixel_hi = cell_has_hi[:, None, :, None].expand(
        ch, cell, cw, cell).reshape(ch * cell, cw * cell)[:h, :w]
    return torch.where(per_pixel_hi, hi, lo)


def select_topk_grid(
    score: torch.Tensor,
    n_keypoints: int,
    cell: int,
    per_cell: int = 4,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatially-uniform top-K selection over a score map.

    Replaces DistributeOctTree (ref: src/ORBextractor.cc:539-763): the
    best `per_cell` responses in each fixed cell, then the global top
    `n_keypoints` among those.  Ties go to the lower index, as in
    jnp.argmax and jax.lax.top_k: torch.argmax takes the first maximum,
    and the global pick is a stable descending sort (torch.topk promises
    no order among equal values, and FAST scores tie often).

    Returns (xy (n,2) int32 as (x, y), response (n,), valid (n,) bool).
    """
    h, w = score.shape
    dev = score.device
    ch = -(-h // cell)
    cw = -(-w // cell)
    pad = F.pad(score, (0, cw * cell - w, 0, ch * cell - h))
    cells = pad.reshape(ch, cell, cw, cell).permute(0, 2, 1, 3)
    cur = cells.reshape(ch * cw, cell * cell)          # (C, cell*cell)

    c_idx = torch.arange(ch * cw, device=dev)
    base_y = (c_idx // cw) * cell
    base_x = (c_idx % cw) * cell
    lane = torch.arange(cell * cell, device=dev)[None, :]
    cand_scores = []
    cand_xy = []
    for _ in range(per_cell):
        idx = torch.argmax(cur, dim=1)                 # (C,)
        val = torch.gather(cur, 1, idx[:, None])[:, 0]
        cand_scores.append(val)
        cand_xy.append(torch.stack(
            [base_x + idx % cell, base_y + idx // cell], -1))
        cur = torch.where(lane == idx[:, None], torch.zeros_like(cur), cur)

    scores = torch.cat(cand_scores)                    # (C*per_cell,)
    xy = torch.cat(cand_xy)                            # (C*per_cell, 2)

    k = min(n_keypoints, scores.shape[0])
    top_val, top_idx = torch.sort(scores, descending=True, stable=True)
    top_val = top_val[:k]
    top_xy = xy[top_idx[:k]]
    valid = top_val > 0.0
    if k < n_keypoints:
        padn = n_keypoints - k
        top_val = torch.cat([top_val, top_val.new_zeros(padn)])
        top_xy = torch.cat([top_xy, top_xy.new_zeros((padn, 2))])
        valid = torch.cat([valid, valid.new_zeros(padn)])
    return top_xy.int(), top_val, valid
