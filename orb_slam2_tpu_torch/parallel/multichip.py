"""Multi-device scaling: frame-sharded extraction and tracking, and
edge-sharded bundle adjustment, over torch.distributed.

Port of orb_slam2_tpu/parallel/multichip.py, under its names.  The JAX
package laid arrays out with `NamedSharding` over a 1-D "dp" `Mesh` and
let XLA insert the collectives; here each process of an initialised
`torch.distributed` group is one member of the mesh and the collectives
are explicit:

  - **frame-parallel**: rank r runs the frontend (or the whole tracking
    step) on its contiguous block of B / world frames, then the results
    are all-gathered, so every rank holds the batch with a leading B axis,
    as JAX's sharded result does.  No traffic until the gather.
  - **edge-parallel BA**: each rank keeps a contiguous slice of the
    observation edges; cameras and points are replicated.  The per-edge
    residuals, Jacobians and Hessian blocks stay local, and every sum over
    the edge axis is a SUM all-reduce (`ba.optimize`'s `edge_reduce`), the
    counterpart of the psums XLA inserted.  Every rank then holds the same
    reduced sums and takes the same accept / reject decision.

The group is the caller's: `torch.distributed.init_process_group` with
gloo on the CPU or NCCL on CUDA, one rank per card (NCCL takes no two
ranks on one card).  `parallel/dryrun.py` spawns such a group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.ops import frontend
from orb_slam2_tpu_torch.slam import track_step
from orb_slam2_tpu_torch.solvers import ba


@dataclass
class Mesh:
    """This process's place in the 1-D "dp" mesh: the group, its rank and
    size, and the torch device the rank computes on.  `all_reduces`
    counts the SUM all-reduces `all_reduce` has made."""

    group: Any
    rank: int
    size: int
    device: torch.device
    all_reduces: int = 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The SUM of `t` over the group, as a new tensor."""
        out = t.detach().clone().contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        self.all_reduces += 1
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (same shape on each), concatenated along axis
        0 in rank order.  bool tensors travel as uint8."""
        src = t.to(torch.uint8) if t.dtype == torch.bool else t
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts)
        return out.bool() if t.dtype == torch.bool else out

    def block(self, n: int) -> slice:
        """This rank's contiguous share of `n` items (n divisible by the
        mesh size)."""
        if n % self.size:
            raise ValueError(f"{n} items do not split over {self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The mesh over the initialised default group.  `n_devices`, when
    given, must be its size.  With NCCL each rank computes on card
    `rank % device_count`; with any other backend on the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"asked for {n_devices} devices, the group has "
                         f"{size}")
    rank = dist.get_rank()
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        device = torch.device("cpu")
    return Mesh(dist.group.WORLD, rank, size, device)


# ---------------------------------------------------------------------------
# frame-parallel extraction
# ---------------------------------------------------------------------------

def extract_batch_sharded(
    mesh: Mesh,
    imgs,
    n_features: int = 500,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> frontend.Features:
    """Extract ORB features for a batch of frames, sharded over the mesh.

    imgs: (B, H, W) numpy array or tensor with B divisible by the mesh
    size; every rank passes the same batch and extracts its own block.
    Returns Features with a leading batch axis on `mesh.device`, the same
    on every rank."""
    local = [frontend.extract(
        torch.as_tensor(im).to(mesh.device), n_features, n_levels,
        scale_factor, 20, 7, 24)
        for im in imgs[mesh.block(len(imgs))]]
    return frontend.Features(*(
        mesh.all_gather(torch.stack(field))
        for field in zip(*local)))


# ---------------------------------------------------------------------------
# frame-parallel FULL tracking step (multi-camera rig / multi-session
# mapping): the fused per-frame program — frontend, motion-model
# matching, pose LM, local-map matching, second pose LM — one block of
# frames per rank.
# ---------------------------------------------------------------------------

def track_step_sharded(mesh: Mesh, settings, imgs_l, imgs_r,
                       scal, last_f32, last_desc, last_oct, last_ang,
                       loc_f32, loc_desc) -> track_step.TrackOut:
    """Run the stereo tracking step for B frames sharded over the mesh.

    imgs_l / imgs_r: (B, H, W); every other argument is the single-frame
    step's input with a leading B axis (numpy, descriptors np.uint32 or
    int32; see slam/track_step.py).  Returns TrackOut with a leading B
    axis on `mesh.device`: the packed f32 outputs and the descriptors."""
    step = track_step.build_track_step(settings, "stereo", mesh.device)
    names = ("img_l", "img_r", "scal", "last_f32", "last_desc", "last_oct",
             "last_angle", "loc_f32", "loc_desc")
    batch = (imgs_l, imgs_r, scal, last_f32, last_desc, last_oct, last_ang,
             loc_f32, loc_desc)
    packs, descs = [], []
    for i in range(len(imgs_l))[mesh.block(len(imgs_l))]:
        out = step(*convert.track_inputs_from_numpy(
            {k: np.asarray(a[i]) for k, a in zip(names, batch)},
            mesh.device))
        packs.append(out.f32_pack.to(mesh.device))
        descs.append(out.desc)
    return track_step.TrackOut(mesh.all_gather(torch.stack(packs)),
                               mesh.all_gather(torch.stack(descs)))


# ---------------------------------------------------------------------------
# edge-parallel global bundle adjustment
# ---------------------------------------------------------------------------

def shard_ba_problem(mesh: Mesh, prob: ba.BAProblem) -> ba.BAProblem:
    """This rank's contiguous slice of the edge arrays (E divisible by the
    mesh size), cameras and points replicated, all on `mesh.device`."""
    edges = mesh.block(prob.edge_cam.shape[0])
    dev = mesh.device
    return ba.BAProblem(
        cam_T=prob.cam_T.to(dev),
        cam_fixed=prob.cam_fixed.to(dev),
        cam_mask=prob.cam_mask.to(dev),
        pts=prob.pts.to(dev),
        pt_mask=prob.pt_mask.to(dev),
        edge_cam=prob.edge_cam[edges].to(dev),
        edge_pt=prob.edge_pt[edges].to(dev),
        edge_uv=prob.edge_uv[edges].to(dev),
        edge_inv_sigma2=prob.edge_inv_sigma2[edges].to(dev),
        edge_mask=prob.edge_mask[edges].to(dev),
    )


def optimize_sharded(mesh: Mesh, prob: ba.BAProblem, fx, fy, cx, cy, bf,
                     iters: int = 5, mode: str = "cg"):
    """Schur-LM bundle adjustment with the edges sharded over the mesh:
    `ba.optimize` on this rank's edges with every edge sum all-reduced.
    Returns (cam_T, pts, err), the same on every rank."""
    return ba.optimize(
        shard_ba_problem(mesh, prob), fx, fy, cx, cy, bf, iters=iters,
        use_kernel=True, mode=mode, edge_reduce=mesh.all_reduce,
    )


# ---------------------------------------------------------------------------
# synthetic problem for dry runs
# ---------------------------------------------------------------------------

def synthetic_ba_problem(n_cams: int = 8, n_pts: int = 128,
                         n_edges: int = 1024, seed: int = 0,
                         device="cuda"):
    """The JAX package's seeded recipe (the same numpy draws): points in a
    4 m cube 6 m ahead, cameras along x, noisy mono observations, points
    perturbed by 5 cm, camera 0 fixed.  Returns (BAProblem on `device`,
    (fx, fy, cx, cy, bf))."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    cam_T = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    cam_T[:, 0, 3] = np.linspace(0, 1, n_cams)
    fx = fy = 300.0
    cx, cy = 160.0, 120.0
    e_cam = rng.integers(0, n_cams, n_edges)
    e_pt = rng.integers(0, n_pts, n_edges)
    pc = np.einsum(
        "eij,ej->ei", cam_T[e_cam, :3, :3], pts[e_pt]
    ) + cam_T[e_cam, :3, 3]
    u = fx * pc[:, 0] / pc[:, 2] + cx
    v = fy * pc[:, 1] / pc[:, 2] + cy
    uv = np.stack([u, v, -np.ones_like(u)], -1).astype(np.float32)
    uv[:, :2] += rng.normal(0, 0.5, (n_edges, 2))
    cam_fixed = np.zeros(n_cams, bool)
    cam_fixed[0] = True
    return convert.ba_problem_from_numpy(
        cam_T, cam_fixed, np.ones(n_cams, bool),
        pts + rng.normal(0, 0.05, pts.shape).astype(np.float32),
        np.ones(n_pts, bool), e_cam, e_pt, uv,
        np.ones(n_edges, np.float32), np.ones(n_edges, bool),
        device=device,
    ), (fx, fy, cx, cy, 0.0)
