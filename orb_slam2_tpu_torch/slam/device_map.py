"""Device-resident mirror of the map-point store.

The host `MapStore` owns the map; this mirror keeps the point fields the
per-frame step needs (position, normal, scale band, descriptor, validity)
resident in device memory.  Mutations are batched: the store records
dirty point ids, and `flush()` uploads one packed delta and runs one
scatter before the next frame dispatch.

This is what makes frame pipelining sound: the chained step carries
point IDS and gathers positions from the mirror at execution time, so
bundle-adjustment updates reach later frames instead of the chain
riding a stale snapshot (see tracking.py's pipelined notes).

Port of orb_slam2_tpu/slam/device_map.py.  There every flush makes new
arrays, and an in-flight dispatch keeps reading the old ones.  Here the
mirror sits at a FIXED device address that a captured CUDA graph reads:
the buffers are allocated once and a delta is applied in place
(`index_copy_`, padding rows going to a dump row past the end), enqueued
on the caller's current stream -- the stream that replays the step.  So
a flush lands between two replays in stream order and never overlaps
one.  Growing past the capacity moves the buffers; `moves` counts that,
and the chained step's graphs are captured again for the new address.
"""

from __future__ import annotations

from typing import Set

import numpy as np
import torch

from orb_slam2_tpu_torch.utils import torch_device

MIN_DELTA_ROWS = 256


def delta_rows(n: int) -> int:
    """Rows a delta of `n` points is padded to: a power of two, at least
    256, so that a run meets few delta shapes."""
    return max(MIN_DELTA_ROWS, 1 << int(np.ceil(np.log2(max(n, 2)))))


def _apply_delta(f32_buf, desc_buf, pids, delta_f32, delta_desc) -> None:
    """Scatter one packed update batch into the mirror, in place.

    f32_buf: (P + 1, 9) [pos3, normal3, min, max, valid]; desc_buf:
    (P + 1, 8) int32 holding the uint32 words' bits.  Rows of `pids` with
    -1 are padding and go to the dump row P."""
    dump = f32_buf.shape[0] - 1
    idx = torch.where(pids >= 0, pids, dump).long()
    f32_buf.index_copy_(0, idx, delta_f32)
    desc_buf.index_copy_(0, idx, delta_desc)


class DeviceMap:
    def __init__(self, store, cap: int = 1 << 15, *, device):
        self.store = store
        self.device = torch_device(device)
        self.cap = cap
        self.moves = 0          # times the buffers moved (growth)
        self.flushes = 0
        self.rows_flushed = 0
        self._alloc(cap)
        self.dirty: Set[int] = set()
        store.dirty_sinks.append(self.dirty)

    def _alloc(self, cap: int) -> None:
        # one row more than the capacity: the dump row of padding
        self._f32 = torch.zeros((cap + 1, 9), dtype=torch.float32,
                                device=self.device)
        self._desc = torch.zeros((cap + 1, 8), dtype=torch.int32,
                                 device=self.device)
        self.f32 = self._f32[:cap]
        self.desc = self._desc[:cap]

    def _grow(self, need: int) -> None:
        new_cap = self.cap
        while new_cap < need:
            new_cap *= 2
        old_f32, old_desc, old_cap = self.f32, self.desc, self.cap
        self._alloc(new_cap)
        self.f32[:old_cap].copy_(old_f32)
        self.desc[:old_cap].copy_(old_desc)
        self.cap = new_cap
        self.moves += 1

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """Host->device copy on the current stream; from pinned memory and
        non-blocking on a card."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def flush(self) -> None:
        """Upload all dirty point rows in one batched scatter."""
        if not self.dirty:
            return
        store = self.store
        pids = np.fromiter(self.dirty, np.int64, len(self.dirty))
        self.dirty.clear()
        if store.n_pt > self.cap:
            self._grow(store.n_pt)
        pids = pids[pids < self.cap]
        n = len(pids)
        if n == 0:
            return
        n_pad = delta_rows(n)
        idx = np.full(n_pad, -1, np.int32)
        idx[:n] = pids
        delta = np.zeros((n_pad, 9), np.float32)
        delta[:n, 0:3] = store.pt_pos[pids]
        delta[:n, 3:6] = store.pt_normal[pids]
        delta[:n, 6] = store.pt_min_dist[pids]
        delta[:n, 7] = store.pt_max_dist[pids]
        delta[:n, 8] = store.pt_valid[pids]
        ddesc = np.zeros((n_pad, 8), np.uint32)
        ddesc[:n] = store.pt_desc[pids]
        _apply_delta(self._f32, self._desc, self._up(idx), self._up(delta),
                     self._up(ddesc.view(np.int32)))
        self.flushes += 1
        self.rows_flushed += n
