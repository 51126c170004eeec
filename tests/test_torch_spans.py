"""The port's spans and counters: `utils.StageTimers` and what the System
records with it.

- A System run on the golden sequence (CPU): one `frame` span a call,
  with the id of the frame it builds; every span inside its parent and
  under its frame's id; the eager step's six device stages inside the
  step's own run; the keyframe's queue wait and pass on the mapper under
  the span that inserted it; `stats()` and `trace_snapshot()` as plain
  data.
- The recorder alone: a bounded ring; totals and counts as the JAX
  package's StageTimers (the port's former one) gives them, so the
  benchmark's readers of them read the same; no profiler range without
  a profiler, and under one each span's range at the span's own time;
  lock waits timed; the samples view that chip_smoke.py reads.
- The keyframe decision's counters with a stub mapper.
"""

import importlib.util
import itertools
import json
import statistics
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from orb_slam2_tpu import utils as jutils
from orb_slam2_tpu_torch import utils
from orb_slam2_tpu_torch.config import Sensor
from orb_slam2_tpu_torch.slam import track_step
from orb_slam2_tpu_torch.system import System
from test_torch_golden import _settings, golden_pairs

torch.set_num_threads(2)

N_FRAMES = 10
METRICS = Path(__file__).resolve().parent.parent / "slambench" / "metrics"


@pytest.fixture(scope="module")
def golden_run():
    system = System(_settings(), Sensor.STEREO, device="cpu")
    for i, (l, r) in enumerate(golden_pairs(N_FRAMES)):
        system.track_stereo(l, r, i * 0.1)
    snap = system.trace_snapshot()
    system.shutdown()
    return system, snap


def _by_id(spans):
    return {s["span"]: s for s in spans}


def _frame_of(s, by_id):
    while s["name"] != "frame" and s["parent"] in by_id:
        s = by_id[s["parent"]]
    return s


def test_one_frame_span_a_call_with_its_frame_id(golden_run):
    _, snap = golden_run
    frames = [s for s in snap["spans"]["tracker"] if s["name"] == "frame"]
    assert [s["id"] for s in frames] == list(range(N_FRAMES))
    assert all(s["parent"] == 0 for s in frames)


def test_spans_nest_in_their_parent_under_its_frame_id(golden_run):
    _, snap = golden_run
    spans = snap["spans"]["tracker"]
    by_id = _by_id(spans)
    host = [s for s in spans if s["thread"] != "device"]
    nested = 0
    for s in host:
        assert s["start_ns"] <= s["end_ns"]
        p = by_id.get(s["parent"])
        if p is not None:
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"], (s["name"], p["name"])
            nested += 1
    assert nested == len(host) - N_FRAMES
    for s in spans:
        f = _frame_of(s, by_id)
        assert f["name"] == "frame" and s["id"] == f["id"], s["name"]


def test_eager_step_stamps_its_six_stages_inside_its_run(golden_run):
    """On the CPU the stamps read the host clock: the six stages tile the
    step's run (`fast/launch`) in order."""
    _, snap = golden_run
    spans = snap["spans"]["tracker"]
    steps = [s for s in spans if s["name"] == "fast_step"]
    assert len(steps) >= N_FRAMES - 3
    for step in steps:
        kids = [s for s in spans if s["parent"] == step["span"]]
        stages = [s for s in kids if s["thread"] == "device"]
        assert [s["name"] for s in stages] == list(track_step.STAGES)
        launch = [s for s in spans if s["name"] == "fast/launch"
                  and s["id"] == step["id"]]
        assert len(launch) == 1
        launch = launch[0]
        for a, b in zip(stages, stages[1:]):
            assert a["end_ns"] == b["start_ns"]
        assert launch["start_ns"] <= stages[0]["start_ns"]
        assert stages[-1]["end_ns"] <= launch["end_ns"]
        total = sum(s["end_ns"] - s["start_ns"] for s in stages)
        assert 0 < total <= launch["end_ns"] - launch["start_ns"]
        names = {s["name"] for s in spans if s["id"] == step["id"]}
        assert {"track/lock_wait", "fast/prep", "fast/dispatch",
                "fast/upload", "fast/pull", "fast/bind",
                "fast/apply"} <= names


def test_mapper_spans_carry_the_keyframe_under_its_maker(golden_run):
    system, snap = golden_run
    tracker = _by_id(snap["spans"]["tracker"])
    lm = snap["spans"]["mapper"]
    passes = [s for s in lm if s["name"] == "lm/keyframe"]
    waits = [s for s in lm if s["name"] == "lm/queue_wait"]
    n_kf = snap["counters"]["keyframes_inserted"]
    assert n_kf >= 1 and len(passes) == len(waits) == n_kf
    for p, w in zip(passes, waits):
        assert p["id"] == w["id"] and p["parent"] == w["parent"]
        maker = tracker[p["parent"]]
        assert system.store.kf_frame_id[p["id"]] == maker["id"]
        assert w["end_ns"] <= p["start_ns"]
        stages = [s for s in lm if s["parent"] == p["span"]]
        assert {s["name"] for s in stages} >= {"lm/lock_wait",
                                               "lm/process_new_kf"}
        assert all(s["id"] == p["id"] for s in stages)


def test_stats_and_snapshot_are_plain_data(golden_run):
    system, snap = golden_run
    json.dumps(snap)
    stats = system.stats()
    for k, v in snap["counters"].items():
        assert stats[k] == v
    assert set(snap["counters"]) == {
        "keyframes_inserted", "keyframes_refused_busy",
        "keyframes_denied_c2", "fast_path_fallbacks",
        "local_ba_interrupted", "mapper_queue_max", "graph_captures"}
    assert snap["counters"]["graph_captures"] == 0     # no graphs on a CPU
    assert snap["counters"]["mapper_queue_max"] >= 1
    assert set(snap["spans"]) == {"tracker", "mapper", "loop"}


def test_ring_stays_bounded():
    t = utils.StageTimers()
    for i in range(100_000):
        with t("a", id=i):
            pass
    assert len(t.ring) == utils.StageTimers.RING
    assert t.counts["a"] == 100_000
    assert len(t.samples["a"]) == utils.StageTimers.RING
    assert t.spans()[-1]["id"] == 99_999


def _scripted(timers):
    """One scripted run of spans through `timers`, as the tracker and the
    mapper nest them."""
    for frame in range(7):
        with timers("pipelined_step" if frame % 3 == 0 else "fast_step"):
            with timers("fast/prep"):
                pass
            with timers("fast/dispatch"):
                pass
        if frame % 2:
            with timers("lm/process_new_kf"):
                pass
            with timers("lm/local_ba"):
                with timers("lm/ba_gather"):
                    pass
                with timers("lm/ba_device"):
                    pass
            with timers("lm/cull_keyframes"):
                pass


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_totals_and_counts_as_the_former_timers(monkeypatch):
    """On one scripted clock the port's timers keep the totals and counts
    of the JAX package's StageTimers, the port's former one, so the
    benchmark's readers of them read the same."""
    def run(make):
        ticks = itertools.count()
        steps = [0.0011, 0.0173, 0.0004, 0.2069, 0.0302]
        monkeypatch.setattr(time, "perf_counter", lambda: sum(
            steps[k % 5] for k in range(next(ticks))))
        monkeypatch.setattr(time, "perf_counter_ns", lambda: round(1e9 * sum(
            steps[k % 5] for k in range(next(ticks)))))
        t = make()
        _scripted(t)
        monkeypatch.undo()
        return t

    old, new = run(jutils.StageTimers), run(utils.StageTimers)
    assert dict(new.counts) == dict(old.counts)
    assert set(new.totals) == set(old.totals)
    for k in old.totals:
        assert new.totals[k] == pytest.approx(old.totals[k], rel=1e-9,
                                              abs=1e-9)
    state = [{k: (t.counts[k], t.totals[k]) for k in t.totals}
             for t in (old, new)]
    frames = SimpleNamespace(frames=[None] * 9, profiled=range(0))
    for name, key in (("mapper.ms_per_kf", "mapper"),
                      ("tracker.fast_path_pct", "tracker")):
        read = _reader(name)
        a, b = (read(SimpleNamespace(timers={key: s}, window=frames))
                for s in state)
        assert a is not None and b == pytest.approx(a, rel=1e-9)


def test_no_profiler_range_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened")

    monkeypatch.setattr(utils, "_mirror", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    t = utils.StageTimers()
    with t("a", cpu=True):
        with t.locked(threading.Lock(), "wait"):
            t.record("b", 1, 2)
    assert t.counts["a"] == t.counts["wait"] == t.counts["b"] == 1


def test_spans_mirror_onto_a_running_profiler():
    """Under a CPU profiler each span is an `orb/<name>` range of the
    trace, and one offset takes the ring's spans to within 50 us of their
    ranges."""
    t = utils.StageTimers()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with utils._mirror("warm-up"):
            pass
        for i in range(20):
            with t("outer", id=i):
                with t("inner", cpu=True):
                    time.sleep(0.0002)
    events = sorted((e.start_ns(), e.name()) for e in
                    prof.profiler.kineto_results.events()
                    if e.name().startswith("orb/"))
    spans = sorted((s["start_ns"], "orb/" + s["name"]) for s in t.spans())
    assert [n for _, n in events] == [n for _, n in spans]
    diffs = [a - b for (a, _), (b, _) in zip(events, spans)]
    offset = statistics.median(diffs)
    # a thread descheduled between a range's start and its span's (other
    # test processes share the cores) may leave one or two out
    near = [abs(d - offset) < 50_000 for d in diffs]
    assert sum(near) >= 0.9 * len(near)


@pytest.mark.parametrize("form", [torch.tensor, list])
def test_stamps_make_the_spans_record_would(form):
    """A step's stamps, as the eager step's tensor or GraphStep's list,
    give the spans and totals that one `record` a stage gives."""
    ns = [1_000, 4_000, 4_500, 9_000, 9_200, 15_000, 15_100, 0]
    got, want = utils.StageTimers(), utils.StageTimers()
    with got("frame", id=7):
        got.record_stamps(form(ns), track_step.STAGES)
    with want("frame", id=7):
        for i, name in enumerate(track_step.STAGES):
            want.record(name, ns[i], ns[i + 1], thread="device")
    def fields(s):
        return {k: v for k, v in s.items() if k not in ("span", "parent")}

    *stages, frame = got.spans()
    assert [fields(s) for s in stages] == [fields(s)
                                           for s in want.spans()[:-1]]
    assert all(s["parent"] == frame["span"] for s in stages)
    assert {k: (got.counts[k], got.totals[k]) for k in track_step.STAGES} \
        == {k: (want.counts[k], want.totals[k]) for k in track_step.STAGES}


def test_lock_wait_times_the_acquire():
    t = utils.StageTimers()
    lock = threading.Lock()
    lock.acquire()
    threading.Timer(0.05, lock.release).start()
    with t.locked(lock, "wait"):
        assert lock.locked()
        assert t.samples["wait"][0] >= 0.04
    assert not lock.locked()


def test_samples_view_keeps_the_reads_of_chip_smoke(monkeypatch):
    monkeypatch.setattr(utils.StageTimers, "RING", 4)
    t = utils.StageTimers()
    assert t.samples.get("x", []) == [] and t.samples["x"] == []
    for dt in (0.001, 0.002, 0.003):
        t.add("x", dt)
    t.add("y", 0.5)
    assert t.samples["x"][-1] == pytest.approx(0.003)
    assert {k: round(v[-1], 3) for k, v in t.samples.items()} == {
        "x": 0.003, "y": 0.5}
    t.add("y", 0.25)                  # the ring holds the last four
    assert len(t.samples["x"]) == 2 and t.counts["x"] == 3
    assert "median" in t.report()


class _BusyMapper:
    def __init__(self, queued):
        self.queued, self.interrupts = queued, 0

    def accepting_keyframes(self):
        return False

    def interrupt_ba(self):
        self.interrupts += 1

    def queue_size(self):
        return self.queued


def test_keyframes_refused_and_denied_are_counted(golden_run, monkeypatch):
    system, _ = golden_run
    tracker = system.tracker
    c = tracker.timers.counters
    monkeypatch.setattr(tracker.store, "tracked_points_in_kf",
                        lambda kf, min_obs: 1000)
    monkeypatch.setattr(tracker, "last_kf_frame_id", -100)
    refused, denied = (c["keyframes_refused_busy"],
                       c["keyframes_denied_c2"])
    busy = _BusyMapper(queued=3)
    monkeypatch.setattr(tracker, "local_mapper", busy)
    monkeypatch.setattr(tracker, "n_inliers", 16)
    assert tracker._need_new_keyframe() is False
    assert busy.interrupts == 1
    assert c["keyframes_refused_busy"] == refused + 1
    monkeypatch.setattr(tracker, "local_mapper", _BusyMapper(queued=2))
    assert tracker._need_new_keyframe() is True
    assert c["keyframes_refused_busy"] == refused + 1
    monkeypatch.setattr(tracker, "n_inliers", 10)
    assert tracker._need_new_keyframe() is False
    assert c["keyframes_denied_c2"] == denied + 1
    assert c["keyframes_refused_busy"] == refused + 1
