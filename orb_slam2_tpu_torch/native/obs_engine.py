"""Observation engine: C++-backed point->observer structure with a
pure-Python fallback (same API).  Copied from orb_slam2_tpu/native; see
mapcore.cpp for the native side."""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np

from orb_slam2_tpu_torch import native


class PyObsEngine:
    """Pure-Python fallback mirroring the mapcore C API."""

    def __init__(self):
        self._obs: Dict[int, List[Tuple[int, int, int]]] = {}
        self._n: Dict[int, int] = {}

    def add(self, pid: int, kf: int, feat: int, weight: int) -> bool:
        v = self._obs.setdefault(pid, [])
        for o in v:
            if o[0] == kf:
                return False
        v.append((kf, feat, weight))
        self._n[pid] = self._n.get(pid, 0) + weight
        return True

    def add_batch(self, pids, kf, feats, weights) -> np.ndarray:
        """Same-kf batched add; returns a bool added-mask per row."""
        out = np.zeros(len(pids), bool)
        for i, (p, f, w) in enumerate(zip(pids, feats, weights)):
            out[i] = self.add(int(p), int(kf), int(f), int(w))
        return out

    def erase(self, pid: int, kf: int) -> int:
        v = self._obs.get(pid)
        if not v:
            return -1
        for i, o in enumerate(v):
            if o[0] == kf:
                self._n[pid] = self._n.get(pid, 0) - o[2]
                del v[i]
                return o[1]
        return -1

    def clear_point(self, pid: int):
        self._obs.pop(pid, None)
        self._n.pop(pid, None)

    def clear(self):
        self._obs.clear()
        self._n.clear()

    def n_obs(self, pid: int) -> int:
        return self._n.get(pid, 0)

    def count(self, pid: int) -> int:
        return len(self._obs.get(pid, ()))

    def items(self, pid: int) -> List[Tuple[int, int]]:
        return [(o[0], o[1]) for o in self._obs.get(pid, ())]

    def find(self, pid: int, kf: int) -> int:
        for o in self._obs.get(pid, ()):
            if o[0] == kf:
                return o[1]
        return -1

    def dump(self, pids: np.ndarray):
        """All (pid_index, kf, feat) observation rows for a pid list."""
        idx, kfs, feats = [], [], []
        for i, pid in enumerate(pids):
            for o in self._obs.get(int(pid), ()):
                idx.append(i)
                kfs.append(o[0])
                feats.append(o[1])
        return (np.array(idx, np.int32), np.array(kfs, np.int32),
                np.array(feats, np.int32))

    def observers_of(self, pids: np.ndarray, exclude_kf: int = -1,
                     cap: int = 4096):
        counter: Dict[int, int] = {}
        for pid in pids:
            pid = int(pid)
            if pid < 0:
                continue
            for o in self._obs.get(pid, ()):
                if o[0] != exclude_kf:
                    counter[o[0]] = counter.get(o[0], 0) + 1
        items = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
        items = items[:cap]
        if not items:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        kfs, counts = zip(*items)
        return (np.array(kfs, np.int32), np.array(counts, np.int32))

    # pickling support
    def export_state(self):
        return dict(self._obs)

    def import_state(self, state):
        self.clear()
        for pid, v in state.items():
            for kf, feat, weight in v:
                self.add(pid, kf, feat, weight)


class NativeObsEngine:
    """ctypes wrapper over mapcore (see mapcore.cpp)."""

    def __init__(self, lib):
        self._lib = lib
        self._h = lib.mapcore_create()
        self._buf_kf = (ctypes.c_int32 * 4096)()
        self._buf_ct = (ctypes.c_int32 * 4096)()

    def __del__(self):
        try:
            self._lib.mapcore_destroy(self._h)
        except Exception:
            pass

    def add(self, pid, kf, feat, weight) -> bool:
        return bool(self._lib.mapcore_add_obs(
            self._h, int(pid), int(kf), int(feat), int(weight)))

    def add_batch(self, pids, kf, feats, weights) -> np.ndarray:
        """Same-kf batched add; returns a bool added-mask per row."""
        pids = np.ascontiguousarray(np.asarray(pids, np.int64))
        feats = np.ascontiguousarray(np.asarray(feats, np.int32))
        weights = np.ascontiguousarray(np.asarray(weights, np.int32))
        out = np.zeros(len(pids), np.uint8)
        p32 = ctypes.POINTER(ctypes.c_int32)
        self._lib.mapcore_add_obs_batch(
            self._h,
            pids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            int(kf), feats.ctypes.data_as(p32),
            weights.ctypes.data_as(p32), len(pids),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out.astype(bool)

    def erase(self, pid, kf) -> int:
        return self._lib.mapcore_erase_obs(self._h, int(pid), int(kf))

    def clear_point(self, pid):
        self._lib.mapcore_clear_point(self._h, int(pid))

    def clear(self):
        self._lib.mapcore_clear(self._h)

    def n_obs(self, pid) -> int:
        return self._lib.mapcore_n_obs(self._h, int(pid))

    def count(self, pid) -> int:
        return self._lib.mapcore_count(self._h, int(pid))

    def items(self, pid):
        n = self._lib.mapcore_get_obs(
            self._h, int(pid), self._buf_kf, self._buf_ct, 4096)
        return [(self._buf_kf[i], self._buf_ct[i]) for i in range(n)]

    def find(self, pid, kf) -> int:
        return self._lib.mapcore_find(self._h, int(pid), int(kf))

    def dump(self, pids: np.ndarray):
        """All (pid_index, kf, feat) observation rows for a pid list."""
        pids = np.ascontiguousarray(np.asarray(pids, np.int64))
        cap = max(64, 8 * len(pids))
        while True:
            idx = np.empty(cap, np.int32)
            kfs = np.empty(cap, np.int32)
            feats = np.empty(cap, np.int32)
            p32 = ctypes.POINTER(ctypes.c_int32)
            n = self._lib.mapcore_dump_obs(
                self._h,
                pids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(pids),
                idx.ctypes.data_as(p32), kfs.ctypes.data_as(p32),
                feats.ctypes.data_as(p32), cap,
            )
            if n < cap:
                return idx[:n], kfs[:n], feats[:n]
            cap *= 4

    def observers_of(self, pids: np.ndarray, exclude_kf: int = -1,
                     cap: int = 4096):
        pids = np.ascontiguousarray(np.asarray(pids, np.int64))
        n = self._lib.mapcore_count_observers(
            self._h,
            pids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(pids), int(exclude_kf),
            self._buf_kf, self._buf_ct, cap,
        )
        return (np.frombuffer(self._buf_kf, np.int32, n).copy(),
                np.frombuffer(self._buf_ct, np.int32, n).copy())

    def export_state(self):
        # export by walking pids is impossible without a pid list; the
        # store passes one in save(); see MapStore.save
        raise NotImplementedError

    def import_state(self, state):
        self.clear()
        for pid, v in state.items():
            for kf, feat, weight in v:
                self.add(pid, kf, feat, weight)


def make_engine(prefer_native: bool = True):
    if prefer_native:
        lib = native.load()
        if lib is not None:
            return NativeObsEngine(lib)
    return PyObsEngine()


def distinctive_index(descs: np.ndarray) -> int:
    """Min-median-Hamming representative descriptor index
    (native when available)."""
    lib = native.load()
    n = len(descs)
    if lib is not None:
        d = np.ascontiguousarray(descs, np.uint32)
        return int(lib.mapcore_distinctive(
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n))
    from orb_slam2_tpu_torch.slam.map_store import hamming_np

    if n == 1:
        return 0
    dm = hamming_np(descs[:, None], descs[None, :])
    return int(np.argmin(np.median(dm, axis=1)))
