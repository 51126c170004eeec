"""Offers a cell's frames to the System and times what the user sees.

Open loop (`"arrival": "open"`): frame i is due at t0 + i / fps, a fixed
schedule that never resets, and is offered at its due time or, when the
system is still busy with an earlier frame, as soon as the call before
it returns.  The window holds the frames due in its first `seconds`.
Closed loop (`"arrival": "closed"`): the next frame is offered as soon
as the call before it returns, until `seconds` have passed.

A frame's latency runs from its due time (closed loop: its offer) to
its authoritative pose landing in the tracker's trajectory; a frame
without one, or lost, has none.  The harness stamps a landing when it
sees the entry, right after each call and between calls while it waits,
and then calls `watch(window)` (harness/check.py's FrameCatcher).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch


@dataclass
class Frame:
    due: float
    offered: float = 0.0
    returned: float = 0.0
    landed: Optional[float] = None
    ok: bool = False


@dataclass
class Window:
    t0: float
    t_close: float                     # t0 + seconds
    frames: List[Frame] = field(default_factory=list)
    drain_s: float = 0.0
    drained: bool = False              # everything settled within the bound
    profiled: range = range(0)         # frames inside the profiled sub-window


class Lander:
    """Stamps trajectory entries as they appear (one per frame, in order)."""

    def __init__(self, system, window: Window, fps: float, watch=None):
        self.s, self.w, self.fps, self.seen = system, window, fps, 0
        self.watch = watch

    def note(self) -> None:
        traj = self.s.tracker.trajectory
        now = time.perf_counter()
        if len(traj) < self.seen:          # a reset began a new trajectory
            self.seen = 0
        while self.seen < len(traj):
            e = traj[self.seen]
            i = int(round(e.timestamp * self.fps))
            if 0 <= i < len(self.w.frames):
                f = self.w.frames[i]
                if f.landed is None:
                    f.landed, f.ok = now, not e.lost
            self.seen += 1
        if self.watch is not None:
            self.watch(self.w)


def run_window(system, track: Callable, frames: list, mix: dict,
               fps: float, seconds: float, profile=None,
               prefetch: bool = False, watch=None) -> Window:
    """Offer `frames` (tuples of host images) per the mix.  `profile`:
    (first, count, hooks) where hooks.start() / hooks.stop() bracket the
    frames first .. first + count - 1; in an open loop a negative `first`
    counts back from the window's last due frame, so that the profiler's
    own stop, which reads the trace's buffers, falls after the window."""
    open_loop = mix["arrival"] == "open"
    n_max = len(frames)
    t0 = time.perf_counter()
    t_close = t0 + seconds
    w = Window(t0=t0, t_close=t_close)
    land = Lander(system, w, fps, watch)
    pipelined = bool(getattr(system.settings, "pipelined", False))
    first = count = -1
    hooks = None
    if profile is not None:
        first, count, hooks = profile
        if first < 0 and open_loop:
            first += int(math.ceil(seconds * fps))
    i = 0
    while i < n_max:
        now = time.perf_counter()
        if open_loop:
            due = t0 + i / fps
            if due >= t_close:
                break
            while now < due:
                if pipelined and system.poll():
                    land.note()
                with torch.profiler.record_function("slambench.pace"):
                    time.sleep(min(0.002, due - now))
                now = time.perf_counter()
        else:
            if now >= t_close:
                break
            due = now
        if i == first:
            hooks.start()
        f = Frame(due=due, offered=time.perf_counter())
        w.frames.append(f)
        with torch.profiler.record_function("slambench.call"):
            track(*frames[i], i / fps)
        f.returned = time.perf_counter()
        land.note()
        if prefetch and i + 1 < n_max:
            system.prefetch(*frames[i + 1])
        if i == first + count - 1:
            hooks.stop()
            w.profiled = range(first, first + count)
        i += 1
    return w


def drain(system, window: Window, fps: float, bound_s: float,
          watch=None) -> None:
    """Land the frames still in flight and let the mapper and the loop
    closer settle, for at most `bound_s` seconds."""
    land = Lander(system, window, fps, watch)
    t = time.perf_counter()
    lc = system.loop_closer
    while True:
        system.poll()
        land.note()
        quiet = (not system.tracker._pending and system.local_mapper.idle()
                 and (lc is None or lc.idle()))
        if quiet or time.perf_counter() - t >= bound_s:
            window.drained = quiet
            break
        time.sleep(0.005)
    window.drain_s = time.perf_counter() - t
