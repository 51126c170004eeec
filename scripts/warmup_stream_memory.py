"""The card's memory after each of four stereo Systems built, precompiled
and shut down in one process, with the tracking steps warmed up on one
stream a device (the port's) or on a new stream a capture ("old").

    python3 scripts/warmup_stream_memory.py own|old

cuBLAS keeps a workspace for every stream it runs on, so a new warm-up
stream a capture leaves memory allocated after every System.  Prints one
JSON line: torch.cuda.memory_allocated() after each System, and after
cuBLAS's workspaces are cleared.
"""

import copy
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import bench_torch as b  # noqa: E402
from orb_slam2_tpu_torch.config import Sensor  # noqa: E402
from orb_slam2_tpu_torch.slam import track_step  # noqa: E402
from orb_slam2_tpu_torch.system import System  # noqa: E402


def main(variant: str) -> None:
    if not torch.cuda.is_available():
        sys.exit("warmup_stream_memory: torch.cuda.is_available() is false")
    if variant == "old":
        track_step._warmup_stream = torch.cuda.Stream
    dev = torch.device("cuda", 0)
    allocated = []
    for i in range(4):
        s = copy.copy(b.kitti_settings())
        s.pipelined = i % 2 == 0
        system = System(s, Sensor.STEREO, scheduler="async", device=dev)
        system.precompile()
        system.shutdown()
        del system
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        allocated.append(torch.cuda.memory_allocated(dev))
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({
        "variant": variant, "allocated_after_each": allocated,
        "after_clearing_cublas_workspaces": torch.cuda.memory_allocated(dev),
        "gpu": b.gpu_line()}))


if __name__ == "__main__":
    main(sys.argv[1])
