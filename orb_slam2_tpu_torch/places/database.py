"""Keyframe database: BoW inverted file for loop / relocalization retrieval.

Copy of orb_slam2_tpu/places/database.py (host-side, no framework).

Equivalent of KeyFrameDatabase (ref: src/KeyFrameDatabase.cc, 311 LoC):
word -> keyframe inverted lists, shared-word counting with the
0.8*maxCommonWords gate, covisibility-group score accumulation, and the
0.75*bestAccScore retention rule.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np


class KeyFrameDatabase:
    def __init__(self, vocabulary):
        self.voc = vocabulary
        self.inverted: Dict[int, Set[int]] = defaultdict(set)
        self.bow: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    # ------------------------------------------------------------------
    def add(self, kf: int, word: np.ndarray):
        """Register a keyframe from its per-feature word ids
        (ref: KeyFrameDatabase::add src/KeyFrameDatabase.cc:40)."""
        ids, weights = self.voc.bow_vector(word)
        self.bow[kf] = (ids, weights)
        for w in ids:
            self.inverted[int(w)].add(kf)

    def erase(self, kf: int):
        ids_weights = self.bow.pop(kf, None)
        if ids_weights is None:
            return
        for w in ids_weights[0]:
            self.inverted[int(w)].discard(kf)

    def clear(self):
        self.inverted.clear()
        self.bow.clear()

    def score(self, a: int, b: int) -> float:
        ia, wa = self.bow[a]
        ib, wb = self.bow[b]
        return self.voc.score_l1(ia, wa, ib, wb)

    def score_against(self, ids, weights, kf: int) -> float:
        ib, wb = self.bow[kf]
        return self.voc.score_l1(ids, weights, ib, wb)

    # ------------------------------------------------------------------
    def _shared_word_counts(self, ids: np.ndarray,
                            exclude: Set[int]) -> Dict[int, int]:
        counts: Dict[int, int] = defaultdict(int)
        for w in ids:
            for kf in self.inverted.get(int(w), ()):
                if kf not in exclude:
                    counts[kf] += 1
        return counts

    def detect_loop_candidates(self, kf: int, min_score: float, store,
                               ids: Optional[np.ndarray] = None,
                               weights: Optional[np.ndarray] = None
                               ) -> List[int]:
        """ref: KeyFrameDatabase::DetectLoopCandidates
        (src/KeyFrameDatabase.cc:76-197): exclude covisible keyframes,
        count shared words, gate at 0.8*max, score those above min_score,
        accumulate over covisibility groups, retain >= 0.75*bestAcc.

        The query keyframe's BoW vector may be passed explicitly (the
        loop closer queries BEFORE adding the keyframe to the database,
        matching the reference's ordering)."""
        if ids is None:
            ids, weights = self.bow.get(kf, (None, None))
        if ids is None or len(ids) == 0:
            return []
        covisible = set(store.covis.get(kf, {})) | {kf}
        counts = self._shared_word_counts(ids, covisible)
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = int(0.8 * max_common)
        scored = []
        for cand, c in counts.items():
            if c <= min_common or not store.kf_valid[cand]:
                continue
            s = self.score_against(ids, weights, cand)
            if s >= min_score:
                scored.append((cand, s))
        if not scored:
            return []
        # accumulate scores over each candidate's top-10 covisible group
        acc = []
        best_acc = min_score
        for cand, s in scored:
            group = store.best_covisibles(cand, 10)
            acc_score = s
            best_kf, best_s = cand, s
            in_scored = dict(scored)
            for g in group:
                if g in in_scored:
                    acc_score += in_scored[g]
                    if in_scored[g] > best_s:
                        best_kf, best_s = g, in_scored[g]
            acc.append((best_kf, acc_score))
            best_acc = max(best_acc, acc_score)
        th = 0.75 * best_acc
        out, seen = [], set()
        for best_kf, acc_score in acc:
            if acc_score > th and best_kf not in seen:
                seen.add(best_kf)
                out.append(best_kf)
        return out

    def detect_reloc_candidates(self, word: np.ndarray,
                                store) -> List[int]:
        """ref: KeyFrameDatabase::DetectRelocalizationCandidates
        (src/KeyFrameDatabase.cc:199-311): same pipeline without the
        covisible exclusion or the min-score gate."""
        ids, weights = self.voc.bow_vector(word)
        if len(ids) == 0:
            return []
        counts = self._shared_word_counts(ids, set())
        counts = {k: c for k, c in counts.items() if store.kf_valid[k]}
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = int(0.8 * max_common)
        scored = {
            cand: self.score_against(ids, weights, cand)
            for cand, c in counts.items() if c > min_common
        }
        if not scored:
            return []
        acc = []
        best_acc = 0.0
        for cand, s in scored.items():
            group = store.best_covisibles(cand, 10)
            acc_score = s
            best_kf, best_s = cand, s
            for g in group:
                if g in scored:
                    acc_score += scored[g]
                    if scored[g] > best_s:
                        best_kf, best_s = g, scored[g]
            acc.append((best_kf, acc_score))
            best_acc = max(best_acc, acc_score)
        th = 0.75 * best_acc
        out, seen = [], set()
        for best_kf, acc_score in acc:
            if acc_score > th and best_kf not in seen:
                seen.add(best_kf)
                out.append(best_kf)
        return out
