"""Latency runs from each frame's due time on a schedule that never
resets: a stall delays the frames behind it, and their latency says so."""

import math
import types

import pytest

import run
from harness import drive


class Clock:
    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += s


class FakeSystem:
    """Tracks a frame in `service` seconds (a stall at `stall_at`) and lands
    its pose when the call returns, as the sync System does."""

    def __init__(self, clock, service, stall_at=-1, stall=0.0, fps=10.0):
        self.clock, self.service = clock, service
        self.stall_at, self.stall = stall_at, stall
        self.settings = types.SimpleNamespace(pipelined=False)
        self.tracker = types.SimpleNamespace(trajectory=[], _pending=[])
        self.local_mapper = types.SimpleNamespace(idle=lambda: True)
        self.loop_closer = None
        self.fps = fps

    def track(self, img, ts):
        i = int(round(ts * self.fps))
        self.clock.t += self.service + (self.stall if i == self.stall_at
                                        else 0.0)
        self.tracker.trajectory.append(types.SimpleNamespace(
            timestamp=ts, lost=False))

    def poll(self):
        return 0


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(drive, "time", c)
    return c


def _window(clock, sys_, seconds=3.0, arrival="open", fps=10.0):
    frames = [(None,)] * 200
    w = drive.run_window(sys_, sys_.track, frames, {"arrival": arrival}, fps,
                         seconds)
    drive.drain(sys_, w, fps, 1.0)
    return w


def test_on_time_frames_wait_only_for_their_own_call(clock):
    s = FakeSystem(clock, 0.04)
    w = _window(clock, s)
    lat = run.latencies_ms(w, True, clock.t)
    assert len(lat) == 30
    assert all(math.isclose(x, 40.0, abs_tol=1e-6) for x in lat)


def test_a_stall_delays_the_frames_due_behind_it(clock):
    s = FakeSystem(clock, 0.04, stall_at=5, stall=1.0)
    w = _window(clock, s)
    lat = run.latencies_ms(w, True, clock.t)
    assert math.isclose(lat[5], 1040.0, abs_tol=1e-6)
    # frame 6 was due 100 ms after frame 5 and is offered when it returns
    assert math.isclose(lat[6], 1040.0 - 100.0 + 40.0, abs_tol=1e-6)
    # the backlog shrinks by 60 ms a frame until the schedule is met again
    assert math.isclose(lat[7], lat[6] - 60.0, abs_tol=1e-6)
    assert all(math.isclose(x, 40.0, abs_tol=1e-6) for x in lat[24:])
    # the tail is the stall and its wake: p95 of 30 is the second largest
    assert run.quantile(lat, 0.95) == pytest.approx(980.0)


def test_the_window_holds_the_frames_due_in_it(clock):
    s = FakeSystem(clock, 0.25)          # slower than the camera
    w = _window(clock, s, seconds=2.0)
    assert len(w.frames) == 20           # all due in the window, offered late
    assert w.frames[-1].offered - w.frames[-1].due > 2.0


def test_closed_loop_offers_on_return_and_counts_the_window(clock):
    s = FakeSystem(clock, 0.0625, fps=30.0)
    w = _window(clock, s, seconds=2.0, arrival="closed", fps=30.0)
    assert len(w.frames) == 32
    assert all(f.offered == f.due for f in w.frames)
    assert sum(f.landed <= w.t_close for f in w.frames) == 32


def test_a_frame_without_a_pose_waits_until_the_drain_gives_up(clock):
    s = FakeSystem(clock, 0.04)
    w = _window(clock, s)
    w.frames[3].ok = False
    lat = run.latencies_ms(w, True, w.frames[3].due + 9.0)
    assert lat[3] == pytest.approx(9000.0)


def test_quantile_is_nearest_rank():
    xs = list(range(1, 101))
    assert run.quantile(xs, 0.95) == 95
    assert run.quantile(xs, 0.5) == 50
    assert run.quantile([], 0.5) == math.inf
