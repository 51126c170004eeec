"""FrameCatcher copies a frame's points only while the map holds still:
the epoch it noted at the landing is read again under the lock that the
copy takes, since a bundle adjustment writes back under that lock and
bumps the epoch only at its end."""

import threading
from types import SimpleNamespace

import numpy as np

from harness.check import FrameCatcher


class _Store:
    """A map whose writer finishes (moves every point, bumps the epoch)
    while a reader waits for its lock, `writes` times."""

    def __init__(self, writes: int):
        self.geo_epoch = 0
        self.pt_pos = np.zeros((4, 3), np.float32)
        self._lock = threading.Lock()
        self.writes = writes
        self.lock = self

    def __enter__(self):
        self._lock.acquire()
        if self.writes:
            self.writes -= 1
            self.pt_pos += 1.0
            self.geo_epoch += 1

    def __exit__(self, *exc):
        self._lock.release()


def _frame(i: int):
    n = 4
    feats = SimpleNamespace(
        xy=np.zeros((n, 2), np.float32), octave=np.zeros(n, np.int32),
        angle=np.zeros(n, np.float32), desc=np.zeros((n, 8), np.int32),
        valid=np.ones(n, bool), ur=np.zeros(n, np.float32),
        depth=np.ones(n, np.float32))
    return SimpleNamespace(Tcw=np.eye(4), bindings=np.arange(n),
                           timestamp=i / 10.0, feats=feats)


def _catch(writes: int):
    store = _Store(writes)
    tracker = SimpleNamespace(last_frame=None, state=SimpleNamespace(
        name="OK"))
    system = SimpleNamespace(map=store, tracker=tracker)
    catcher = FrameCatcher(system, seconds=1.0, fps=10.0, seed=7, k=1,
                           quiet_notes=2)
    window = SimpleNamespace(t0=-1e9)
    for i in range(4):
        tracker.last_frame = _frame(i)
        catcher(window)
    return catcher


def test_a_still_map_is_caught_at_the_first_quiet_landing():
    c = _catch(writes=0)
    assert c.passed_over == 0
    assert [x["index"] for x in c.caught] == [1]
    assert (c.caught[0]["pts"] == 0.0).all()


def test_points_moved_while_the_copy_waits_are_passed_over():
    c = _catch(writes=1)
    assert c.passed_over == 1
    assert [x["index"] for x in c.caught] == [3]
    assert (c.caught[0]["pts"] == 1.0).all()
