"""Package-level properties of orb_slam2_tpu_torch: no JAX inside, nothing
built at import, CPU tensors on the plain path, the kernels' CUDA entry
points refusing anything else, and the conversion helpers."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_slam2_tpu.config import RectificationParams as JRect
from orb_slam2_tpu.config import Settings as JSettings
from orb_slam2_tpu.ops import brief as jbrief
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.config import Settings
from orb_slam2_tpu_torch.ops import (
    brief, consts, cuda_build, fast_cuda, frontend, orb_cuda, orientation,
    stereo, stereo_cuda,
)
from orb_slam2_tpu_torch.slam import track_step

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "orb_slam2_tpu_torch"


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


_FRAME = """
import numpy as np, torch
torch.set_num_threads(2)
from orb_slam2_tpu_torch import Settings
from orb_slam2_tpu_torch.slam.frame import FrameBuilder
from synthetic import CylinderScene, circle_trajectory
K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
scene = CylinderScene(K, 96, 128, radius=8.0)
T = circle_trajectory(4)[1]
s = Settings(fx=100.0, fy=100.0, cx=64, cy=48, bf=50.0, width=128,
             height=96, n_features=200)
f = FrameBuilder(s, device="cpu").stereo_pair(scene.render(T),
                                              scene.render(T), 0.0)
assert f.feats.valid.sum() > 20
"""


def test_import_and_frame_leave_jax_out():
    out = _run(_FRAME + """
import sys
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "orb_slam2_tpu")))
""")
    assert out.strip() == "[]", out


def test_slam_modules_leave_jax_out():
    """The modules of the SLAM loop (native/, io/, apps/, system.py and
    the mapper) import no jax and no JAX package, and the no-jax source
    rule below reads each of their files."""
    mods = ("native.obs_engine", "io.datasets", "io.trajectory",
            "apps.run_slam", "system", "slam.local_mapping",
            "slam.tracking", "slam.kf_mirror", "slam.device_map",
            "precompile", "solvers.ba", "solvers.triangulation", "convert",
            # place recognition, relocalization and loop closing
            "places.database", "places.vocabulary", "geometry.sim3",
            "solvers.horn", "solvers.epnp", "solvers.sim3_solver",
            "solvers.pose_graph", "slam.relocalization",
            "slam.loop_closing", "slam.global_ba",
            # mono initialization and the fork's 2D grid
            "solvers.initializer", "mapping2d.gridmap", "mapping2d.stream",
            # the viewers and multi-device
            "viz.viewer", "viz.live", "viz.ar", "parallel.multichip",
            "parallel.dryrun")
    out = _run("import importlib, sys\n"
               + "".join(f"importlib.import_module('orb_slam2_tpu_torch.{m}')\n"
                         for m in mods)
               + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                 "('jax', 'jaxlib', 'orb_slam2_tpu')))")
    assert out.strip() == "[]", out
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    for m in mods:
        assert m.replace(".", "/") + ".py" in files, m


def test_every_subpackage_is_walked_and_helpers_leave_jax_out():
    """The source rule reads every sub-package (places/ and mapping2d/
    included), and the helper modules under tests/ that chip_smoke.py
    imports load without jax."""
    subs = {p.relative_to(PKG).parts[0] for p in PKG.rglob("*.py")
            if len(p.relative_to(PKG).parts) > 1}
    assert {"places", "solvers", "geometry", "slam", "ops", "io", "apps",
            "native", "mapping2d", "viz", "parallel"} <= subs
    assert (PKG / "places" / "__init__.py").exists()
    assert (PKG / "mapping2d" / "__init__.py").exists()
    out = _run("import sys\n"
               f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
               "import bench_reference, test_torch_ring_map, "
               "test_torch_track_blocks\n"
               "print(sorted(m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'orb_slam2_tpu', 'torch')))")
    assert out.strip() == "[]", out


def test_every_module_of_the_jax_package_has_its_counterpart():
    """The two packages' file lists differ only by the port's own
    additions: each Pallas kernel's module is a CUDA module here, and
    convert.py, ops/consts.py and ops/cuda_build.py are new."""
    jax_pkg = ROOT / "orb_slam2_tpu"
    a = {p.relative_to(jax_pkg).as_posix() for p in jax_pkg.rglob("*.py")}
    b = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    pallas = {f"ops/{k}_pallas.py" for k in ("fast", "orb", "stereo")}
    cuda = {f"ops/{k}_cuda.py" for k in ("fast", "orb", "stereo")}
    assert a - b == pallas
    assert b - a == cuda | {"convert.py", "ops/consts.py",
                            "ops/cuda_build.py"}


@pytest.mark.parametrize("name", ["System", "run_slam", "LoopCloser",
                                  "Relocalizer", "dryrun", "bench_torch"])
def test_entry_points_ask_for_the_card(name):
    """Entry points default to the card or require the device by
    keyword; none falls back to the CPU by itself."""
    import inspect

    from orb_slam2_tpu_torch.apps import run_slam
    from orb_slam2_tpu_torch.slam.loop_closing import LoopCloser
    from orb_slam2_tpu_torch.slam.relocalization import Relocalizer
    from orb_slam2_tpu_torch.system import System

    if name == "run_slam":
        src = inspect.getsource(run_slam.main)
        assert '"--device", default="cuda"' in src
        return
    if name == "dryrun":
        from orb_slam2_tpu_torch.parallel import dryrun

        src = inspect.getsource(dryrun.main)
        assert 'choices=("cpu", "cuda"), default="cuda"' in src
        return
    if name == "bench_torch":
        sys.path.insert(0, str(ROOT))
        import bench_torch

        src = inspect.getsource(bench_torch.main)
        assert 'choices=("cuda", "cpu"), default="cuda"' in src
        return
    param = inspect.signature(
        {"System": System, "LoopCloser": LoopCloser,
         "Relocalizer": Relocalizer}[name].__init__).parameters["device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY
    if name == "System":
        assert param.default == "cuda"
    else:
        assert param.default is inspect.Parameter.empty


def test_import_builds_nothing():
    """Importing every module and running a CPU frame neither runs nvcc
    nor loads or writes the kernels' library."""
    out = _run("""
import pkgutil, importlib, subprocess
def refuse(*a, **k):
    raise AssertionError(f"subprocess started: {a}")
subprocess.Popen = refuse
import orb_slam2_tpu_torch
for m in pkgutil.walk_packages(orb_slam2_tpu_torch.__path__,
                               "orb_slam2_tpu_torch."):
    importlib.import_module(m.name)
""" + _FRAME + """
from orb_slam2_tpu_torch.ops import cuda_build
print(cuda_build.library.cache_info().currsize)
""")
    assert out.strip() == "0", out
    assert not any(cuda_build.BUILD_DIR.glob("*.tmp"))


def test_cpu_tensors_take_plain_path():
    """A frame on CPU tensors launches no kernel."""
    for m in (fast_cuda, orb_cuda, stereo_cuda):
        m.launches = 0
    rng = np.random.default_rng(0)
    left = rng.integers(0, 256, (96, 160), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    sf = torch.tensor(1.2 ** np.arange(8), dtype=torch.float32)
    f, m = frontend.extract_stereo_pair(
        torch.from_numpy(left), torch.from_numpy(right), sf, 40.0, 100.0,
        n_features=200)
    assert int(f.valid.sum()) > 20
    assert (fast_cuda.launches, orb_cuda.launches, stereo_cuda.launches) \
        == (0, 0, 0)


def _kernel_calls(device):
    img = torch.zeros((64, 64), dtype=torch.float32, device=device)
    xy = torch.full((4, 2), 32, dtype=torch.int32, device=device)
    valid = torch.ones(4, dtype=torch.bool, device=device)
    idx = torch.full((4,), 20, dtype=torch.int32, device=device)
    xyf, best = xy.float(), idx.long()
    scal = torch.zeros((), dtype=torch.float32, device=device)
    return {
        "fast": lambda f: f(img, 20, 7, 16),
        "orb": lambda f: f(img, img, xy, valid),
        "stereo": lambda f: f(img, img, idx, idx, idx),
        "stereo_refine": lambda f: f(img, img, xyf, xyf, best, idx, scal,
                                     scal, scal),
    }


_ENTRY = {
    "fast": (fast_cuda.detect_with_fallback_cuda,
             fast_cuda.detect_with_fallback),
    "orb": (orb_cuda.describe_oriented_cuda, orb_cuda.describe_oriented),
    "stereo": (stereo_cuda.sad_strips_cuda, stereo_cuda.sad_strips),
    "stereo_refine": (stereo_cuda.refine_cuda, stereo_cuda.refine),
}


@pytest.mark.parametrize("name", sorted(_ENTRY))
def test_kernel_entry_points_refuse_non_cuda_tensors(name):
    """The CUDA entry point raises on a CPU tensor instead of moving it;
    the dispatching wrapper sends a tensor on any device but the CPU to
    the kernel, so a meta tensor raises too — it never falls back."""
    cuda_fn, wrapper = _ENTRY[name]
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernel_calls("cpu")[name](cuda_fn)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernel_calls("meta")[name](wrapper)
    assert cuda_build.library.cache_info().currsize == 0


def test_check_tensor_rejects_what_kernels_do_not_take():
    dev = torch.device("cpu")
    t = torch.zeros((4, 6), dtype=torch.float32)
    cuda_build.check_tensor(t, "t", torch.float32, (4, None), dev)
    with pytest.raises(TypeError):
        cuda_build.check_tensor(t.double(), "t", torch.float32, (4, 6), dev)
    with pytest.raises(ValueError, match="shape"):
        cuda_build.check_tensor(t, "t", torch.float32, (4, 5), dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_build.check_tensor(t.T, "t", torch.float32, (6, 4), dev)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        cuda_build.check_error(700, "x")


@pytest.mark.parametrize("rect", [False, True])
def test_settings_from_jax_round_trip(rect):
    js = JSettings(fx=718.856, fy=718.856, cx=607.19, cy=185.22,
                   bf=386.1448, width=1240, height=376, n_features=2000,
                   th_depth=9.5, k1=0.01)
    if rect:
        eye = np.eye(3)
        js.rectification = JRect(eye, eye, np.zeros(5), np.zeros(5), eye,
                                 eye, np.eye(3, 4), np.eye(3, 4), 1240, 376)
    ts = convert.settings_from_jax(js)
    assert isinstance(ts, Settings)
    import dataclasses

    jd, td = dataclasses.asdict(js), dataclasses.asdict(ts)
    assert jd.keys() == td.keys()
    for k in jd:
        if k == "rectification" and rect:
            for kk in jd[k]:
                np.testing.assert_array_equal(td[k][kk], jd[k][kk])
        else:
            assert td[k] == jd[k], k
    np.testing.assert_array_equal(ts.scale_factors(), js.scale_factors())
    assert ts.has_distortion and ts.depth_threshold == js.depth_threshold


def test_pattern_from_numpy_round_trip():
    """A custom pattern installed from numpy gives the JAX package's
    descriptors with that pattern; the default is restored after."""
    import jax.numpy as jnp

    pattern = jbrief.generate_pattern(5)
    rng = np.random.default_rng(1)
    blurred = rng.uniform(0, 255, (80, 90)).astype(np.float32)
    xy = rng.integers(20, 60, (32, 2)).astype(np.int32)
    ang = rng.uniform(0, 360, 32).astype(np.float32)
    valid = np.ones(32, bool)
    default = jbrief.get_pattern()
    try:
        jbrief.set_pattern(pattern)
        convert.pattern_from_numpy(pattern)
        np.testing.assert_array_equal(brief.get_pattern(), pattern)
        ref = np.asarray(jbrief.describe(jnp.asarray(blurred),
                                         jnp.asarray(xy), jnp.asarray(ang),
                                         jnp.asarray(valid)))
        out = brief.describe(torch.from_numpy(blurred), torch.from_numpy(xy),
                             torch.from_numpy(ang), torch.from_numpy(valid))
        same = (out.numpy().view(np.uint32) == ref).all(1)
        assert same.mean() >= 0.99
    finally:
        jbrief.set_pattern(default)
        convert.pattern_from_numpy(default)
    np.testing.assert_array_equal(brief.get_pattern(), default)
    with pytest.raises(ValueError):
        convert.pattern_from_numpy(pattern[:10])


def test_features_to_numpy_views_descriptors_as_uint32():
    desc = torch.tensor([[-1, 0, 1, -2147483648, 5, 6, 7, 8]],
                        dtype=torch.int32)
    f = frontend.Features(torch.zeros((1, 2)), torch.zeros(1),
                          torch.zeros(1, dtype=torch.int32), torch.zeros(1),
                          desc, torch.ones(1, dtype=torch.bool))
    out = convert.features_to_numpy(f)
    assert out["desc"].dtype == np.uint32
    assert out["desc"][0, 0] == 0xFFFFFFFF and out["desc"][0, 3] == 2 ** 31
    assert set(out) == {"xy", "octave", "angle", "desc", "valid"}


def test_float32_matmul_is_exact():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_sources_import_no_jax_and_build_flags():
    """No module of the port (nor chip_smoke.py, nor bench_torch.py) imports
    jax or the JAX package; the kernels build for sm_90a without
    --use_fast_math."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|orb_slam2_tpu)\b",
                     re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                       ROOT / "bench_torch.py"]
    assert len(files) > 15
    for p in files:
        assert not pat.search(p.read_text()), p
    assert sorted(p.name for p in (PKG / "csrc").glob("*.cu")) == sorted(
        cuda_build.SOURCES)
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "code=sm_90a" in flags and "fast_math" not in flags


def test_build_track_step_is_memoized_and_eager_on_cpu():
    """On a CPU device the step is the eager function (a GraphStep only
    on CUDA), one per settings, mode and plain flag."""
    s = Settings(fx=100.0, fy=100.0, cx=64, cy=48, bf=50.0, width=128,
                 height=96, n_features=200)
    a = track_step.build_track_step(s, "stereo", device="cpu")
    assert a is track_step.build_track_step(s, True, device="cpu")
    assert a is not track_step.build_track_step(s, "stereo", device="cpu",
                                                plain=True)
    assert a is not track_step.build_track_step(s, "mono", device="cpu")
    assert callable(a) and not isinstance(a, track_step.GraphStep)


def _frontend_constant_users():
    """Outputs of the three users of constant tensors on the plain path:
    stereo.match (bf, min/max disparity), ic_angles (moment weights) and
    brief.describe (the pattern)."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.uniform(0, 255, (64, 96)).astype(np.float32))
    xy = torch.from_numpy(rng.integers(16, 48, (40, 2)).astype(np.int32))
    valid = torch.ones(40, dtype=torch.bool)
    ang = orientation.ic_angles(img, xy, valid)
    desc = brief.describe(img, xy, ang, valid)
    sf = torch.tensor(1.2 ** np.arange(4), dtype=torch.float32)
    oct_ = torch.from_numpy(rng.integers(0, 4, 40).astype(np.int32))
    fxy = xy.float()
    m = stereo.match(fxy, oct_, desc, valid, fxy - 3.0, oct_, desc, valid,
                     img, img.roll(-3, 1), sf, 40.0, 0.0, 100.0)
    return [ang, desc, *m]


def test_plain_path_constants_are_made_once_and_give_the_same_output():
    """After a first call, the plain orientation / BRIEF versions and
    stereo.match make no constant tensor (no host-to-device copy on a
    card); their output is bit-equal to making each constant afresh."""
    first = _frontend_constant_users()
    n_tables, n_scalars = len(consts._tables), len(consts._scalars)
    w10 = consts.table(orientation._W10, "cpu", torch.float64)
    second = _frontend_constant_users()
    assert (len(consts._tables), len(consts._scalars)) == (n_tables,
                                                           n_scalars)
    assert consts.table(orientation._W10, "cpu", torch.float64) is w10
    assert consts.scalar(40.0, "cpu") is consts.scalar(40.0, "cpu")
    orig = consts.table, consts.scalar
    try:
        consts.table = lambda a, dev, dtype: torch.as_tensor(
            a, dtype=dtype, device=dev)
        consts.scalar = lambda v, dev, dtype=torch.float32: (
            v if torch.is_tensor(v) else torch.as_tensor(v, dtype=dtype,
                                                         device=dev))
        fresh = _frontend_constant_users()
    finally:
        consts.table, consts.scalar = orig
    for a, b, c in zip(first, second, fresh):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_constant_tables_follow_a_new_brief_pattern():
    """brief.set_pattern installs a new array, so the next describe uses
    a fresh device copy of it, not the old pattern's."""
    default = brief.get_pattern()
    old = consts.table(brief._PATTERN, "cpu", torch.float32)
    try:
        brief.set_pattern(jbrief.generate_pattern(5))
        new = consts.table(brief._PATTERN, "cpu", torch.float32)
        assert new is not old
        np.testing.assert_array_equal(new.numpy(), brief.get_pattern())
    finally:
        brief.set_pattern(default)


def test_graph_step_keys_inputs_by_shape_and_dtype():
    """numpy and tensor inputs of one shape and dtype share a graph; uint32
    descriptor blocks enter as their int32 bits; another L is another
    graph.  (Capture and replay themselves run on the card only, in
    chip_smoke.py.)"""
    desc = np.array([[0xFFFFFFFF] * 8], np.uint32)
    as_int = track_step._as_input(desc)
    assert as_int.dtype == np.int32 and (as_int == -1).all()
    a = (np.zeros((4, 8), np.int32), None)
    b = (torch.zeros((4, 8), dtype=torch.int32), None)
    c = (np.zeros((5, 8), np.int32), None)
    key = track_step.GraphStep._key
    assert key(a) == key(b) != key(c)
    assert key((track_step._as_input(np.zeros((4, 8), np.uint32)), None)) \
        == key(a)
