"""Relocalization through both Systems: the frames of
tests/test_system_e2e.py::TestRelocalization (40 tracked frames, three
black pairs, then a mapped pose revisited) go through the JAX System and
the port's System on the CPU with the same vocabulary.  Both must lose
tracking on the black frames and relocalize on the same frame, with the
relocalized camera centres within 1e-3 m of each other and within 0.1 m
of the rendered truth."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.config import Sensor as JSensor
from orb_slam2_tpu.ops import frontend as jfrontend
from orb_slam2_tpu.places.vocabulary import Vocabulary as JVocabulary
from orb_slam2_tpu.system import System as JSystem
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.config import Sensor
from orb_slam2_tpu_torch.system import System
from synthetic import CylinderScene, circle_trajectory
from test_system_e2e import BASELINE, H, W, center_of, make_settings

torch.set_num_threads(2)

MAX_DEV_M = 1e-3       # port vs JAX, relocalized camera centre
MAX_ERR_M = 0.1        # either package vs the rendered truth


@pytest.fixture(scope="module")
def world():
    settings = make_settings()
    scene = CylinderScene(settings.K, H, W)
    probe = circle_trajectory(12, orbit_r=2.0, total_angle=2 * np.pi)
    descs = []
    for T in probe:
        f = jfrontend.extract(jnp.asarray(scene.render(T)), n_features=600)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = JVocabulary.train(np.concatenate(descs), k=10, L=3, levels_up=1)
    return settings, scene, voc


def frames(scene):
    """(left, right, timestamp, kind) for the whole run."""
    poses = circle_trajectory(40, orbit_r=2.0, total_angle=np.pi * 0.8)
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -BASELINE
    out = [(scene.render(T), scene.render(Trl @ T), i * 0.2, "track")
           for i, T in enumerate(poses)]
    blank = np.zeros((H, W), np.float32)
    out += [(blank, blank, 100 + j * 0.2, "blank") for j in range(3)]
    T = poses[10]
    left, right = scene.render(T), scene.render(Trl @ T)
    out += [(left, right, 200 + j * 0.2, "revisit") for j in range(3)]
    return out, poses


def drive(system, seq):
    """Per frame: (state name, camera centre or None)."""
    log = []
    for left, right, t, _ in seq:
        T = system.track_stereo(left, right, t)
        log.append((system.tracker.state.name,
                    None if T is None else center_of(np.asarray(T))))
    return log


def test_lost_then_relocalizes_like_jax(world):
    settings, scene, jvoc = world
    seq, poses = frames(scene)
    port = System(convert.settings_from_jax(settings), Sensor.STEREO,
                  vocabulary=convert.vocabulary_from_jax(jvoc), device="cpu")
    log = drive(port, seq)
    jlog = drive(JSystem(settings, JSensor.STEREO, vocabulary=jvoc), seq)

    states = [s for s, _ in log]
    assert states == [s for s, _ in jlog]
    assert states[39] == "OK" and states[42] == "LOST"
    assert states[-1] == "OK"
    first_ok = states.index("OK", 43)
    assert port.tracker.relocalizations >= 1
    # same relocalizing frame, same pose
    dev = np.linalg.norm(log[first_ok][1] - jlog[first_ok][1])
    assert dev < MAX_DEV_M, dev
    Tg = poses[10] @ np.linalg.inv(poses[0])
    err = np.linalg.norm(log[-1][1] - center_of(Tg))
    assert err < MAX_ERR_M, err
    assert port.stats()["relocalizations"] == port.tracker.relocalizations
