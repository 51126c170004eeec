"""Structured logging for every subsystem (SURVEY §5.5 observability).

The reference narrates its lifecycle through scattered couts (loop
closure prints in LoopClosing.cc, the System.cc banners, per-driver
timing dumps).  Here every subsystem logs through the standard
`logging` package under the "orb_slam2" namespace so embedders can
route/filter/format with normal logging config:

    orb_slam2.system        construction, mode switches, reset, savers
    orb_slam2.tracking      state transitions, relocalization, resets
    orb_slam2.mapping       keyframe processing, culling
    orb_slam2.loop          detection, Sim3, correction, GBA lifecycle

Default behavior is silent (WARNING+, no handler — library etiquette).
`set_verbose()` turns on the reference-style narration for drivers.
"""

from __future__ import annotations

import logging

ROOT = "orb_slam2"


def get(name: str) -> logging.Logger:
    """Subsystem logger, e.g. get("loop") -> orb_slam2.loop."""
    return logging.getLogger(f"{ROOT}.{name}")


def set_verbose(level=logging.INFO, stream=None) -> None:
    """Enable console narration like the reference's couts.

    Idempotent: repeated calls adjust the level without stacking
    handlers."""
    root = logging.getLogger(ROOT)
    root.setLevel(level)
    if not any(getattr(h, "_orb_slam2_handler", False)
               for h in root.handlers):
        h = logging.StreamHandler(stream)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s",
            datefmt="%H:%M:%S"))
        h._orb_slam2_handler = True
        root.addHandler(h)
