#!/usr/bin/env python3
"""Row-gather variants for the port's cached lookup on one GPU.

    python3 scripts/gather_ab_torch.py

``CachedSDF`` gathers one packed (value, grad) row of 16 B per point and
link.  This times ways of gathering those rows with PyTorch at the
headline shape: the capsule link's table (res 0.02, padding 1.0:
1,267,875 rows) and the nearest-voxel rows of 200 configurations x 15,251
points of one link (3,050,200 rows), each variant on the same indices and
checked equal to ``index_select``.  Prints the card, each variant's median
time and the bytes bound (rows written once, indices read once).
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import pytorch_volumetric_tpu_torch as pt  # noqa: E402
from pytorch_volumetric_tpu_torch.utils.robots import make_serial_arm  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    q, pts = chip_smoke.headline_inputs(device)
    with tempfile.TemporaryDirectory() as tmp:
        arm = os.path.join(tmp, "arm")
        urdf, end = make_serial_arm(arm, num_joints=7)
        robot = pt.RobotSDF(
            pt.build_serial_chain_from_urdf(open(urdf).read(), end, device=device),
            path_prefix=arm, link_sdf_cls=pt.cache_link_sdf_factory(
                resolution=0.02, padding=1.0, cache_path=os.path.join(tmp, "c.npz")))
    link = 3
    child = robot.sdf.sdfs[link]
    m, _ = robot._link_transforms(q)
    # link-major layout: this link's 200 transforms
    sl = slice(link * q.shape[0], (link + 1) * q.shape[0])
    p = pt.transforms.transform_points(m[sl], pts).reshape(-1, 3)
    lo = torch.as_tensor(child.voxels.lo.astype(np.float32), device=device)
    inv_res = torch.as_tensor(np.float32(1) / child.voxels.res.astype(np.float32),
                              device=device)
    n = torch.as_tensor(child.voxels.shape, device=device)
    strides = torch.as_tensor(child.voxels._strides, device=device)
    keys = torch.round((p - lo) * inv_res).to(torch.int64)
    idx = (torch.minimum(keys.clamp(min=0), n - 1) * strides).sum(-1)
    vg = child.raw_query_aux()
    idx32 = idx.to(torch.int32)
    ref = vg.index_select(0, idx)
    channels = [vg[:, c].contiguous() for c in range(4)]
    variants = {
        "index_select int64": lambda: vg.index_select(0, idx),
        "index_select int32": lambda: vg.index_select(0, idx32),
        "advanced indexing vg[idx]": lambda: vg[idx],
        "embedding": lambda: torch.nn.functional.embedding(idx, vg),
        "take per channel": lambda: torch.stack(
            [ch.take(idx) for ch in channels], dim=-1),
        "gather expanded": lambda: vg.gather(0, idx[:, None].expand(-1, 4)),
    }
    rows = idx.numel()
    bound_ms = rows * (16 + 8) / chip_smoke.PEAK_BYTES_PER_S * 1e3
    print(f"table {tuple(vg.shape)}, rows gathered {rows}, bytes bound {bound_ms:.4f} ms, "
          f"in-grid share {((keys >= 0) & (keys < n)).all(-1).float().mean().item():.3f}")
    for name, fn in variants.items():
        if not torch.equal(fn(), ref):
            sys.exit(f"{name} disagrees with index_select")
        ms = chip_smoke.time_ms(fn, device, reps=20, warmup=3)
        print(f"  {name:28s} {ms:8.4f} ms")


if __name__ == "__main__":
    main()
