"""Bag-of-words vocabulary: array-based hierarchical ORB tree.

Port of orb_slam2_tpu/places/vocabulary.py, the flat-array replacement
for DBoW2's TemplatedVocabulary (ref:
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h): per-node packed
descriptors `(n_nodes, 8)u32`, a children table `(n_nodes, k)i32` and
per-leaf TF-IDF weights.  The per-descriptor tree descent (ref:
TemplatedVocabulary.h:1218-1256, k Hamming tests per level) runs for ALL
N descriptors of a frame at once on the torch device: per level a gather
of the k children, XOR + popcount, and a masked argmin.  The node tables
are uploaded once per device and kept.

Training (binary hierarchical k-medians with bitwise-majority centers,
the FORB::meanValue scheme of DBoW2/FORB.cpp), the ORBvoc.txt text format
(ref: TemplatedVocabulary.h:1338 loadFromTextFile), `bow_vector` and
`score_l1` are numpy and identical to the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from orb_slam2_tpu_torch.ops.hamming import _popcount32
from orb_slam2_tpu_torch.utils import HostCopy, to_numpy, upload

_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint16)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,8)u32 x (M,8)u32 -> (N,M) int32."""
    x = np.bitwise_xor(a[:, None, :], b[None, :, :]).view(np.uint8)
    return _POPCNT8[x].reshape(a.shape[0], b.shape[0], 32).sum(-1).astype(
        np.int32)


def _unpack_bits(desc: np.ndarray) -> np.ndarray:
    """(N,8)u32 -> (N,256) uint8 bit matrix."""
    return np.unpackbits(
        desc.astype("<u4").view(np.uint8), axis=-1, bitorder="little"
    )


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """(N,256) -> (N,8)u32."""
    by = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")
    return by.view("<u4").astype(np.uint32)


class Vocabulary:
    """k-ary tree of depth L with TF-IDF-weighted leaves ("words")."""

    def __init__(self, k: int, L: int,
                 node_desc: np.ndarray, node_children: np.ndarray,
                 node_weight: np.ndarray, node_parent: np.ndarray,
                 levels_up: int = 4):
        self.k = k
        self.L = L
        self.levels_up = levels_up   # ref: Frame::ComputeBoW uses 4
        self.node_desc = node_desc          # (M, 8) u32
        self.node_children = node_children  # (M, k) i32, -1 = none
        self.node_weight = node_weight      # (M,) f32 (leaves only)
        self.node_parent = node_parent      # (M,) i32
        self.is_leaf = (node_children[:, 0] < 0)
        # word ids = dense renumbering of leaves (DBoW2 createWords order)
        leaf_ids = np.nonzero(self.is_leaf)[0]
        self.leaf_of_word = leaf_ids
        self.word_of_node = np.full(len(node_desc), -1, np.int32)
        self.word_of_node[leaf_ids] = np.arange(
            len(leaf_ids), dtype=np.int32)
        self.n_words = len(leaf_ids)
        self._tables = {}   # torch.device -> (node_desc, node_children)

    # ------------------------------------------------------------------
    def _device_tables(self, device: torch.device):
        """The node tables on `device`, uploaded on first use and kept
        (descriptors as int32 holding the uint32 words' bits)."""
        tables = self._tables.get(device)
        if tables is None:
            tables = (upload(self.node_desc.astype(np.uint32), device),
                      upload(self.node_children.astype(np.int32), device))
            self._tables[device] = tables
        return tables

    def descend(self, desc: torch.Tensor, valid: torch.Tensor):
        """(N,8) int32 descriptors -> (node at depth L - levels_up (N,),
        leaf (N,)), int32 on desc's device; -1 on invalid rows."""
        node_desc, children = self._device_tables(desc.device)
        n = desc.shape[0]
        cur = torch.zeros(n, dtype=torch.int64, device=desc.device)  # root
        # after iteration i the walker sits at depth i+1; record the
        # FeatureVector node at depth L - levels_up (DBoW2 semantics)
        record_at = self.L - self.levels_up - 1
        node_mid = cur
        for level in range(self.L):
            ch = children[cur].long()                    # (N, k)
            ch_valid = ch >= 0
            cd = node_desc[ch.clamp(min=0)]              # (N, k, 8)
            d = _popcount32(
                torch.bitwise_xor(cd, desc[:, None, :])).sum(-1)
            d = torch.where(ch_valid, d, 1 << 20)
            best = torch.argmin(d, -1)                   # first minimum
            nxt = torch.gather(ch, 1, best[:, None])[:, 0]
            # leaves can appear early if the tree is ragged
            cur = torch.where(nxt >= 0, nxt, cur)
            if level == record_at:
                node_mid = cur
        node_mid = torch.where(valid, node_mid, -1).int()
        leaf = torch.where(valid, cur, -1).int()
        return node_mid, leaf

    def assign_nodes(self, desc, valid) -> Tuple[np.ndarray, np.ndarray]:
        """Per-descriptor (mid-level node id, word id).

        The mid-level node id feeds the FeatureVector-style node-aligned
        matching (SearchByBoW); the word id feeds BowVector scoring."""
        return self.finalize_nodes(*self.assign_nodes_async(desc, valid))

    def assign_nodes_async(self, desc, valid):
        """Dispatch the vocabulary descent WITHOUT waiting: returns
        (node_mid, leaf, HostCopy of both).  `desc` / `valid` are numpy
        arrays ((N,8) uint32, (N,) bool) or tensors ((N,8) int32 bits);
        tensors run where they lie, arrays on the CPU.  Callers that feed
        node_mid into another device stage use the tensors; call
        `finalize_nodes` on the triple to land the host-side result."""
        device = desc.device if torch.is_tensor(desc) else torch.device(
            "cpu")
        d = (desc if torch.is_tensor(desc) else upload(desc, device))
        v = (valid if torch.is_tensor(valid)
             else torch.from_numpy(np.asarray(valid, bool))).to(device)
        node_mid, leaf = self.descend(d, v)
        return node_mid, leaf, HostCopy(torch.stack([node_mid, leaf]))

    def finalize_nodes(self, node_mid, leaf, copy=None):
        """Host half of assign_nodes: pull + map leaves to word ids."""
        if copy is not None:
            node_mid, leaf = copy.numpy()
        node_mid = to_numpy(node_mid)
        leaf = to_numpy(leaf)
        word = np.where(leaf >= 0, self.word_of_node[np.maximum(leaf, 0)], -1)
        return node_mid.astype(np.int32), word.astype(np.int32)

    def bow_vector(self, word: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Sparse L1-normalized TF-IDF vector from per-feature word ids
        (ref: BowVector + TemplatedVocabulary::transform)."""
        w = word[word >= 0]
        if len(w) == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        ids, counts = np.unique(w, return_counts=True)
        weights = counts * self.node_weight[self.leaf_of_word[ids]]
        keep = weights > 0
        ids, weights = ids[keep], weights[keep]
        s = weights.sum()
        if s > 0:
            weights = weights / s
        return ids.astype(np.int32), weights.astype(np.float32)

    @staticmethod
    def score_l1(ids1, w1, ids2, w2) -> float:
        """L1 similarity over shared words = sum(min(v, w))
        (ref: DBoW2 ScoringObject.cpp:23-67 L1Scoring, rewritten for
        all-positive weights)."""
        common, i1, i2 = np.intersect1d(
            ids1, ids2, assume_unique=True, return_indices=True
        )
        if len(common) == 0:
            return 0.0
        return float(np.minimum(w1[i1], w2[i2]).sum())

    # ------------------------------------------------------------------
    # training (binary hierarchical k-medians)
    # ------------------------------------------------------------------
    @classmethod
    def train(cls, descriptors: np.ndarray, k: int = 10, L: int = 3,
              seed: int = 0, levels_up: Optional[int] = None,
              iters: int = 8) -> "Vocabulary":
        """Hierarchical k-medians over packed ORB descriptors.

        Centers are bitwise majorities (FORB::meanValue's scheme); weights
        are IDF from the training corpus (DBoW2 default TF_IDF weighting,
        TemplatedVocabulary::setNodeWeights)."""
        rng = np.random.default_rng(seed)
        descriptors = np.unique(descriptors, axis=0)
        n_desc = len(descriptors)

        nodes_desc = [np.zeros(8, np.uint32)]   # root placeholder
        nodes_children = [[]]
        nodes_parent = [-1]
        leaf_counts = {}

        # iterative BFS clustering
        queue = [(0, np.arange(n_desc), 0)]   # (node, desc idx, level)
        while queue:
            node, idxs, level = queue.pop(0)
            if level == L or len(idxs) == 0:
                continue
            kk = min(k, max(len(idxs), 1))
            sub = descriptors[idxs]
            # k-medians init: random distinct picks
            picks = rng.choice(len(idxs), size=kk, replace=False)
            centers = sub[picks]
            assign = None
            for _ in range(iters):
                d = _hamming_np(sub, centers)
                assign = np.argmin(d, -1)
                bits = _unpack_bits(sub)
                new_centers = []
                for c in range(kk):
                    m = assign == c
                    if not m.any():
                        new_centers.append(centers[c])
                        continue
                    maj = (bits[m].sum(0) * 2 >= m.sum()).astype(np.uint8)
                    new_centers.append(_pack_bits(maj[None])[0])
                new_centers = np.stack(new_centers)
                if np.array_equal(new_centers, centers):
                    break
                centers = new_centers
            d = _hamming_np(sub, centers)
            assign = np.argmin(d, -1)
            for c in range(kk):
                child_idx = idxs[assign == c]
                if len(child_idx) == 0:
                    continue
                cid = len(nodes_desc)
                nodes_desc.append(centers[c])
                nodes_children.append([])
                nodes_parent.append(node)
                nodes_children[node].append(cid)
                if level + 1 == L:
                    leaf_counts[cid] = len(child_idx)
                else:
                    queue.append((cid, child_idx, level + 1))

        M = len(nodes_desc)
        node_desc = np.stack(nodes_desc).astype(np.uint32)
        node_children = np.full((M, k), -1, np.int32)
        for i, ch in enumerate(nodes_children):
            node_children[i, : len(ch)] = ch
        node_parent = np.array(nodes_parent, np.int32)
        node_weight = np.zeros(M, np.float32)
        # IDF weights: log(N / n_i) over "documents"; with a raw descriptor
        # corpus we use descriptor counts as the reference does with
        # training features per word
        for nid, cnt in leaf_counts.items():
            node_weight[nid] = np.log(max(n_desc, 1) / cnt)
        lu = levels_up if levels_up is not None else min(4, L - 1)
        return cls(k, L, node_desc, node_children, node_weight,
                   node_parent, levels_up=max(lu, 0))

    # ------------------------------------------------------------------
    # ORBvoc.txt-format I/O (ref: TemplatedVocabulary.h:1338
    # loadFromTextFile / saveToTextFile)
    # ------------------------------------------------------------------
    @classmethod
    def load_text(cls, path: str, levels_up: int = 4) -> "Vocabulary":
        """Parse an ORBvoc.txt-format file (header `k L s w`, then one
        node per line: `parentId isLeaf byte0..byte31 weight`, node ids
        implicit in file order starting at 1; ref:
        TemplatedVocabulary.h:1338 loadFromTextFile).

        Vectorized for the real ~1.1M-node k=10/L=6 vocabulary:
        np.loadtxt's C tokenizer + one scatter for the children table.
        Malformed lines (wrong column count) raise instead of being
        silently dropped; a parent with more than k children raises."""
        with open(path) as f:
            header = f.readline().split()
            if len(header) < 2:
                raise ValueError(f"{path}: bad vocabulary header {header!r}")
            k, L = int(header[0]), int(header[1])
            data = np.loadtxt(f, dtype=np.float64, ndmin=2)
        if data.size == 0:
            raise ValueError(f"{path}: vocabulary has no nodes")
        if data.shape[1] != 35:
            raise ValueError(
                f"{path}: expected 35 columns per node line "
                f"(parent isLeaf 32-bytes weight), got {data.shape[1]}")
        parents = data[:, 0].astype(np.int64)
        is_leaf_flag = data[:, 1] != 0
        by = data[:, 2:34]
        if (by < 0).any() or (by > 255).any():
            raise ValueError(f"{path}: descriptor bytes out of [0,255]")
        n = len(parents) + 1   # + implicit root (node 0)
        if (parents < 0).any() or (parents >= n).any():
            raise ValueError(f"{path}: parent id out of range")
        node_desc = np.zeros((n, 8), np.uint32)
        node_desc[1:] = np.ascontiguousarray(
            by.astype(np.uint8)).view("<u4").astype(np.uint32)
        node_parent = np.full(n, -1, np.int32)
        node_parent[1:] = parents
        node_weight = np.zeros(n, np.float32)
        node_weight[1:] = data[:, 34]
        # children table in one scatter: stable-sort nodes by parent and
        # compute each node's slot within its parent's group
        node_children = np.full((n, k), -1, np.int32)
        order = np.argsort(parents, kind="stable")
        p_sorted = parents[order]
        uniq, start, counts = np.unique(
            p_sorted, return_index=True, return_counts=True)
        if counts.size and counts.max() > k:
            bad = uniq[np.argmax(counts)]
            raise ValueError(
                f"{path}: node {bad} has {counts.max()} children > k={k}")
        if np.intersect1d(uniq, np.nonzero(is_leaf_flag)[0] + 1).size:
            raise ValueError(f"{path}: node flagged leaf has children")
        slot = np.arange(len(p_sorted)) - np.repeat(start, counts)
        node_children[p_sorted, slot] = (order + 1).astype(np.int32)
        return cls(k, L, node_desc, node_children, node_weight,
                   node_parent, levels_up=levels_up)

    def save_text(self, path: str):
        n = len(self.node_desc)
        by = self.node_desc.astype("<u4").view(np.uint8)   # (M, 32)
        cols = np.empty((n - 1, 35), np.float64)
        cols[:, 0] = self.node_parent[1:]
        cols[:, 1] = self.is_leaf[1:]
        cols[:, 2:34] = by[1:]
        cols[:, 34] = self.node_weight[1:]
        with open(path, "w") as f:
            f.write(f"{self.k} {self.L} 0 0\n")
            np.savetxt(f, cols,
                       fmt=["%d"] * 34 + ["%.9g"], delimiter=" ")
