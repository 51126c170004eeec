"""harness/spans.py, the per-frame decomposition by the port's spans, and
frame_spans.py, the run that prints it: a traced half-size CPU run (about
a minute) gives the five span metrics as numbers and each frame's parts
summing to it; a snapshot without the spans (a program that records
none) gives None; the trace's clock offset and the idle gaps' labels on
made-up events."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import frame_spans
from harness import spans
from harness.spec import Spec

DATA = Path(__file__).resolve().parent / "data"
ARGS = ["--seed", "2147483671", "--seconds", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def traced():
    torch.set_num_threads(2)
    spec = Spec(json.loads((DATA / "BENCHMARK.json").read_text()), DATA,
                DATA)
    return frame_spans.main(["--workload", "tiny-stereo.open", "--trace",
                             "1"] + ARGS, spec=spec)


def test_the_five_metrics_read_numbers(traced):
    un = traced["unprofiled"]
    assert un["frames"] >= 20 and traced["profiled"]["frames"] >= 1
    for name in spans.METRICS:
        assert isinstance(un[name], float) and un[name] >= 0.0, name
    med = un["median_ms"]
    # the CPU's eager step: its run is the launch, nothing waits
    assert "fast/device_wait" not in med
    assert 0.0 < med["device"] <= med["fast/launch"]
    assert 0.0 <= med["rest"] < med["frame"]
    assert set(traced["counters"]) >= {"keyframes_inserted",
                                       "graph_captures"}


def test_rows_close_on_their_parts(traced):
    med = traced["unprofiled"]["median_ms"]
    parts = sum(med[k] for k in spans.PARTS)
    assert parts <= med["frame"]


def _frame(sid, start, end, **kids):
    out = [dict(span=sid, parent=0, name="frame", id=sid, thread=1,
                start_ns=start, end_ns=end, cpu_ns=-1)]
    t = start
    for k, (name, ms, cpu_ms) in enumerate(kids.values()):
        out.append(dict(span=sid * 100 + k + 1, parent=sid, name=name,
                        id=sid, thread=1, start_ns=t,
                        end_ns=t + int(ms * 1e6),
                        cpu_ns=-1 if cpu_ms is None else int(cpu_ms * 1e6)))
        t += int(ms * 1e6)
    return out


def test_rows_of_a_made_up_frame():
    made = _frame(1, 0, 10_000_000,
                  a=("track/lock_wait", 1.0, None),
                  b=("fast/prep", 2.0, 1.5),
                  c=("fast/dispatch", 5.0, None),
                  d=("fast/apply", 1.5, 1.5))
    snap = {"spans": {"tracker": made, "mapper": [], "loop": []}}
    (row,) = spans.frames(snap)
    assert row["host"] == pytest.approx(10.0 - 1.0)
    assert row["blocked"] == pytest.approx(1.0 + 0.5)
    assert row["rest"] == pytest.approx(10.0 - 9.5)
    window = SimpleNamespace(frames=[SimpleNamespace(offered=-1e-3,
                                                     returned=0.02)],
                             profiled=range(0))
    assert len(spans.frames(snap, window)) == 1
    assert spans.frames(snap, window, profiled=True) == []


def test_no_spans_read_none():
    old = {"spans": {"tracker": _frame(1, 0, 5_000_000), "mapper": [],
                     "loop": []}}
    for snap in (None, old):
        rows = spans.frames(snap)
        assert rows == []
        assert all(fn(rows) is None for fn in spans.METRICS.values())


def test_clock_offset_and_idle_labels():
    off = 5_000_000_123
    ring = [dict(span=k, parent=0, name=n, id=0, thread=1, start_ns=a,
                 end_ns=b, cpu_ns=-1)
            for k, (n, a, b) in enumerate([("frame", 0, 900_000),
                                           ("fast/launch", 100_000, 300_000),
                                           ("frame", 1_000_000, 1_900_000)])]
    events = [(s["start_ns"] + off + 7, s["end_ns"] + off,
               "orb/" + s["name"]) for s in ring]
    got = spans.clock_offset_ns(events, ring, off + 40_000)
    assert got == off + 7
    mapper = [dict(span=9, parent=0, name="lm/local_ba", id=3, thread=2,
                   start_ns=0, end_ns=2_000_000, cpu_ns=-1)]
    gaps = [(off + 150_000, off + 250_000), (off + 500_000, off + 510_000),
            (off + 1_200_000, off + 1_400_000)]
    labels = dict(spans.idle_by_span(gaps, events, mapper, off))
    assert labels == {
        "orb/frame | mapper lm/local_ba": pytest.approx(2e-4),
        "orb/fast/launch | mapper lm/local_ba": pytest.approx(1e-4)}


def test_gaps_are_the_complement_of_busy():
    busy = [[10, 20], [20, 25], [40, 50]]
    assert spans.gaps(busy, 0, 60) == [(0, 10), (25, 40), (50, 60)]
    assert spans.gaps([[0, 60]], 0, 60) == []
    assert spans.gaps([], 5, 9) == [(5, 9)]
