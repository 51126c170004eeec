"""Packed 256-bit Hamming distance.

Port of orb_slam2_tpu/ops/hamming.py (ref: ORBmatcher::DescriptorDistance,
src/ORBmatcher.cc:1647-1663), batched into full distance matrices.
Descriptors are (N, 8) int32 tensors holding the uint32 words' bits.
Every function also takes leading batch dimensions (the mapper's batched
matchers stack B keyframes), broadcast between its operands.
"""

from __future__ import annotations

import torch

MAX_DIST = 256  # all-ones distance used for masked-out entries
TH_LOW = 50     # ref: src/ORBmatcher.cc:38
TH_HIGH = 100   # ref: src/ORBmatcher.cc:37
HISTO_LENGTH = 30  # rotation-consistency bins, ref: src/ORBmatcher.cc:39


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit word (int32 in, int64 out)."""
    v = x.long() & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance: (..., 8) int32 -> (...) int32."""
    return _popcount32(torch.bitwise_xor(a, b)).sum(-1).int()


def unpack_bits(a: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) packed descriptors -> (..., N, 256) int8 bit vectors."""
    shifts = torch.arange(32, device=a.device, dtype=torch.int64)
    bits = (a.long()[..., None] >> shifts) & 1
    return bits.reshape(*a.shape[:-1], 256).to(torch.int8)


def distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) x (..., M, 8) -> (..., N, M) int32 distance matrix.

    Hamming(a, b) = pop(a) + pop(b) - 2 <bits_a, bits_b>.  The inner
    products are a float32 matmul of the 0/1 bit matrices (CUDA matmul
    takes no integer tensors); with TF32 off every partial sum is an
    integer <= 256, so it is exact.
    """
    pa = _popcount32(a).sum(-1)
    pb = _popcount32(b).sum(-1)
    inner = unpack_bits(a).float() @ unpack_bits(b).float().transpose(-1, -2)
    return (pa[..., :, None] + pb[..., None, :] - 2 * inner.long()).int()


def masked_argmin(
    dist: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise best match under a mask, over the last dimension.

    Returns (best_idx (..., N), best_dist (..., N), second_dist (..., N))
    where masked entries count as MAX_DIST; ties go to the first column,
    as in jnp.argmin.
    """
    d = torch.where(mask, dist, torch.full_like(dist, MAX_DIST))
    best_idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, best_idx[..., None])[..., 0]
    d2 = d.scatter(-1, best_idx[..., None], MAX_DIST)
    second = d2.amin(dim=-1)
    return best_idx, best, second


def rotation_histogram_filter(
    angle_q: torch.Tensor,
    angle_t: torch.Tensor,
    matched: torch.Tensor,
    n_keep: int = 3,
) -> torch.Tensor:
    """Keep matches whose angle difference falls in the 3 dominant bins.

    The rot-histogram + ComputeThreeMaxima pattern of every matcher (ref:
    src/ORBmatcher.cc:1601-1645); bins with < 0.1 * max1 count are
    dropped.  Returns a bool mask over matches.  The top bins are taken
    by a stable descending sort, so equal counts go to the lower bin as
    in jax.lax.top_k (torch.topk promises no order among ties).  Leading
    dimensions are separate match sets, each with its own histogram.
    """
    rot = angle_q - angle_t
    rot = torch.where(rot < 0, rot + 360.0, rot)
    bin_idx = torch.floor(rot * (HISTO_LENGTH / 360.0)).long()
    bin_idx = torch.where(bin_idx == HISTO_LENGTH, 0, bin_idx)
    lead = matched.shape[:-1]
    counts = torch.zeros(*lead, HISTO_LENGTH, dtype=torch.int64,
                         device=matched.device).scatter_add(
        -1, bin_idx, matched.long())
    top_val, top_idx = torch.sort(counts, dim=-1, descending=True,
                                  stable=True)
    top_val, top_idx = top_val[..., :n_keep], top_idx[..., :n_keep]
    thresh = (0.1 * top_val[..., :1]).long()   # float32, then truncated
    keep_bin = torch.zeros(*lead, HISTO_LENGTH, dtype=torch.bool,
                           device=matched.device).scatter(
        -1, top_idx, top_val > thresh)
    return matched & torch.gather(keep_bin, -1, bin_idx)
