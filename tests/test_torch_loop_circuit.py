"""A loop closed through the port's System on the CPU: the 80-frame,
1.25-orbit cylinder circuit of tests/test_system_e2e.py::TestLoopClosing
with the synchronous scheduler and a vocabulary trained on the port's own
descriptors.  The loop must close, global BA must finish inline, and the
map must stay consistent.  The comparison with the JAX System on the same
frames (two circuits, minutes on a CPU) is marked slow, as the JAX
package's own is.

This file holds the long cases alone, so that a parallel run (one file a
worker) does not queue other tests behind them."""

import numpy as np
import pytest
import torch

from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.config import Sensor
from orb_slam2_tpu_torch.ops import frontend
from orb_slam2_tpu_torch.places.vocabulary import Vocabulary
from orb_slam2_tpu_torch.system import System
from synthetic import CylinderScene, circle_trajectory
from test_system_e2e import BASELINE, H, W, kf_ate, make_settings

torch.set_num_threads(2)

N_FRAMES, ORBITS = 80, 1.25
MAX_ATE_M = 0.5          # keyframe ATE after the loop, bench.py's bound
MAX_ATE_DEV_M = 0.05     # port vs JAX keyframe ATE on the same frames


@pytest.fixture(scope="module")
def world():
    jsettings = make_settings()
    scene = CylinderScene(jsettings.K, H, W)
    probe = circle_trajectory(12, orbit_r=2.0, total_angle=2 * np.pi)
    descs = []
    for T in probe:
        f = frontend.extract(torch.from_numpy(scene.render(T)),
                             n_features=600)
        d = convert.features_to_numpy(f)
        descs.append(d["desc"][d["valid"]])
    voc = Vocabulary.train(np.concatenate(descs), k=10, L=3, levels_up=1)
    return jsettings, scene, voc


def run_circuit(system, scene):
    poses = circle_trajectory(N_FRAMES, orbit_r=2.0,
                              total_angle=2 * np.pi * ORBITS)
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -BASELINE
    for i, T in enumerate(poses):
        system.track_stereo(scene.render(T), scene.render(Trl @ T), i * 0.2)
    return poses


def check_store(store):
    kfs = store.valid_kf_ids()
    assert np.isfinite(store.kf_pose[kfs]).all()
    pids = store.valid_pt_ids()
    assert np.isfinite(store.pt_pos[pids]).all()
    # every binding of a live keyframe names a live point or nothing
    obs = store.kf_obs[kfs]
    bound = obs[obs >= 0]
    assert store.pt_valid[bound].all()


@pytest.fixture(scope="module")
def port_circuit(world):
    jsettings, scene, voc = world
    system = System(convert.settings_from_jax(jsettings), Sensor.STEREO,
                    vocabulary=voc, device="cpu")
    poses = run_circuit(system, scene)
    return system, poses


def test_port_closes_the_loop(port_circuit):
    system, poses = port_circuit
    lc = system.loop_closer
    assert lc.loops_closed >= 1 and lc.loop_detected
    assert lc.idle() and not lc.queue
    assert lc.gba is not None and lc.gba.runs_finished >= 1
    assert system.tracker.state.name == "OK"
    assert system.store.big_change_idx >= 2      # loop + global BA
    assert any(system.store.kf_loop_edges.values())
    check_store(system.store)
    stats = system.stats()
    assert stats["loops_closed"] == lc.loops_closed
    assert stats["gba_runs_finished"] == lc.gba.runs_finished
    assert kf_ate(system.map, poses, 0.2) < MAX_ATE_M
    # the stages of the closing pass were timed
    for name in ("loop/detect", "loop/sim3_ransac", "loop/sim3_refine",
                 "loop/correct", "loop/essential_graph"):
        assert lc.timers.counts[name] >= 1, name


@pytest.mark.slow
def test_circuit_matches_the_jax_system(world, port_circuit):
    """The JAX System on the same frames with the same tree closes its
    loop too, and the two keyframe ATEs agree."""
    from orb_slam2_tpu.config import Sensor as JSensor
    from orb_slam2_tpu.places.vocabulary import Vocabulary as JVocabulary
    from orb_slam2_tpu.system import System as JSystem

    jsettings, scene, voc = world
    jvoc = JVocabulary(voc.k, voc.L, voc.node_desc, voc.node_children,
                       voc.node_weight, voc.node_parent,
                       levels_up=voc.levels_up)
    jsys = JSystem(jsettings, JSensor.STEREO, vocabulary=jvoc)
    poses = run_circuit(jsys, scene)
    assert jsys.loop_closer.loops_closed >= 1
    port, _ = port_circuit
    assert port.loop_closer.loops_closed == jsys.loop_closer.loops_closed
    dev = abs(kf_ate(port.map, poses, 0.2) - kf_ate(jsys.map, poses, 0.2))
    assert dev < MAX_ATE_DEV_M, dev
