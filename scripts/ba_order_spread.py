"""How far the order of the edge sums moves a bundle adjustment of the
synthetic multi-device problem, on the CPU with the port.

    python scripts/ba_order_spread.py [--orders 40]

Sharding the edges over ranks changes the order in which every edge sum
is added up, as index_add_'s atomics do on a card.  For each problem this
solves the edges in their own order and in `--orders` random orders, and
prints how many of the reordered solves stay within the JAX package's
dry-run bound of the first (rtol 1e-2, atol 5e-3 on cameras and points,
rtol 1e-2 on the error) and the largest differences.  The problems:
`multichip.synthetic_ba_problem` (the JAX recipe: mono edges, camera 0
fixed, so the scale is free) at the JAX dry run's size for 4 ranks and at
the JAX test's size, and `dryrun.ba_problem` (the test's size, cameras 0
and 1 fixed).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from orb_slam2_tpu_torch.parallel import dryrun, multichip  # noqa: E402
from orb_slam2_tpu_torch.solvers import ba  # noqa: E402

EDGE_FIELDS = ("edge_cam", "edge_pt", "edge_uv", "edge_inv_sigma2",
               "edge_mask")


def spread(prob, k, iters: int, orders: int) -> dict:
    ref = ba.optimize(prob, *k, iters=iters, mode="cg")
    E = prob.edge_cam.shape[0]
    within, worst = 0, [0.0, 0.0, 0.0]
    for s in range(orders):
        perm = torch.from_numpy(np.random.default_rng(100 + s).permutation(E))
        q = prob._replace(**{f: getattr(prob, f)[perm] for f in EDGE_FIELDS})
        out = ba.optimize(q, *k, iters=iters, mode="cg")
        d = [float((out[0] - ref[0]).abs().max()),
             float((out[1] - ref[1]).abs().max()),
             abs(float(out[2]) / float(ref[2]) - 1.0)]
        worst = [max(a, b) for a, b in zip(worst, d)]
        within += bool(
            torch.allclose(out[0], ref[0], rtol=1e-2, atol=5e-3)
            and torch.allclose(out[1], ref[1], rtol=1e-2, atol=5e-3)
            and d[2] <= 1e-2)
    return {"within_jax_bound": within, "orders": orders,
            "max_cam_T": worst[0], "max_points_m": worst[1],
            "max_err_rel": worst[2]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--orders", type=int, default=40)
    a = ap.parse_args(argv)
    torch.set_num_threads(2)
    cases = {
        "jax recipe, dry run's 4-rank size (256 edges, 2 iterations)":
            (multichip.synthetic_ba_problem(4, 64, 256, device="cpu"), 2),
        "jax recipe, test's size (512 edges, 4 iterations)":
            (multichip.synthetic_ba_problem(4, 64, 512, device="cpu"), 4),
        "dryrun.ba_problem (512 edges, 4 iterations, 2 cameras fixed)":
            (dryrun.ba_problem("cpu"), dryrun.BA_ITERS),
    }
    for name, ((prob, k), iters) in cases.items():
        print(name, spread(prob, k, iters, a.orders))
    return 0


if __name__ == "__main__":
    sys.exit(main())
