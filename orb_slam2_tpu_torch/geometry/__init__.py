from orb_slam2_tpu_torch.geometry import camera  # noqa: F401
