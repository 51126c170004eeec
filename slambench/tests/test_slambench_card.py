"""On the card (`chip` marker; skips without one): the port's frontend
kernels against the frozen reference at the KITTI configuration's full
size, and the control (the reference's levels in bfloat16) caught."""

import json
from pathlib import Path

import pytest

from harness import check
from harness import scene as scene_mod

ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.mark.chip
def test_port_frontend_equals_reference_at_full_size(card):
    import torch

    from orb_slam2_tpu_torch.config import Settings
    from orb_slam2_tpu_torch.slam.frame import FrameBuilder

    cfg = json.loads((ROOT / "slambench" / "configs" /
                      "kitti00-02-stereo.json").read_text())
    cfg["name"] = "kitti00-02-stereo"
    sc = scene_mod.Cylinder(cfg, card)
    poses = sc.poses(3, 2.25, 2 ** 31 + 7)
    left, _ = sc.render(poses)
    right, _ = sc.render(poses, right=True)
    fb = FrameBuilder(Settings.from_dict(cfg["settings"]), device=card)
    for lf, rf in zip(left, right):
        f = fb.stereo_pair(lf, rf, 0.0).feats
        port = {"xy": f.xy, "octave": f.octave, "angle": f.angle,
                "desc": f.desc, "valid": f.valid, "ur": f.ur,
                "depth": f.depth}
        ref = check._rows(check.reference_frame((lf, rf), cfg, card))
        assert check.rows_differ(port, ref) == 0
        low = check._rows(check.reference_frame((lf, rf), cfg, card,
                                                lowp=True))
        assert check.rows_differ(low, ref) > 0
    torch.cuda.synchronize()
