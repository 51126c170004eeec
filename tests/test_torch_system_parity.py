"""Whole-slice parity with mapping at work: the JAX System and the
port's System (both on the CPU) on a 30-frame 240x320 stereo sequence
that inserts five keyframes, so triangulation, two-way fusion, local BA
and keyframe culling all run.  Keyframes must be inserted on the same
frames and every camera centre must agree within 5 mm."""

import numpy as np
import torch

from orb_slam2_tpu.config import Sensor as JSensor
from orb_slam2_tpu.system import System as JSystem
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.config import Sensor
from orb_slam2_tpu_torch.system import System
from synthetic import stereo_sequence, straight_trajectory
from test_golden import BASELINE, H, W, _settings
from test_torch_golden import run

torch.set_num_threads(2)

MAX_DEV_M = 5e-3


def test_mapping_sequence_matches_jax_system():
    s = _settings()
    poses = straight_trajectory(30, step=0.05, yaw_step=0.02)
    _, pairs = stereo_sequence(s.K, H, W, BASELINE, poses)
    port = System(convert.settings_from_jax(s), Sensor.STEREO, device="cpu")
    kfs, centres = run(port, pairs)
    jkfs, jcentres = run(JSystem(s, JSensor.STEREO), pairs)
    assert len(kfs) >= 4 and kfs == jkfs, (kfs, jkfs)
    assert all(c is not None for c in centres + jcentres)
    dev = max(np.linalg.norm(a - b) for a, b in zip(centres, jcentres))
    assert dev < MAX_DEV_M, dev
    # the mapper's stages ran: triangulation bore points, local BA ran
    t = port.local_mapper.timers
    assert t.counts["lm/triangulate_apply"] >= 2
    assert t.counts["lm/local_ba"] >= 1
    assert t.counts["lm/fuse_apply"] >= 2
    assert (port.store.pt_first_kf[: port.store.n_pt] > 0).any()
