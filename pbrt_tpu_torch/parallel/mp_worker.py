"""One process of a multi-process render and training step (port of
pbrt_tpu/parallel/mp_worker.py).

    python -m pbrt_tpu_torch.parallel.mp_worker --coordinator HOST:PORT \\
        --nprocs N --pid I [--local-devices 2] [--mode render|train|both] \\
        [--res 16] [--spp 4] [--n-spectrum 32] \\
        [--device cuda|cuda:K|cpu] [--backend B] --out PREFIX

Each of the N processes joins the process group (parallel/multiprocess.py)
with --local-devices mesh entries: `cpu` or `cuda:K` repeated, or for
`cuda` (the default) the process's cards in turn. It renders the Cornell
box (PathIntegrator(max_depth=3), K1's tier) pixel-sharded over the
global mesh and/or takes one training step against a flat 0.25 target,
tracing a shard's spp samples in one wave, and writes
`<PREFIX>.<pid>.npz`: the image and its seconds (the first render,
kernel builds included), the loss and gradients, the mesh size, the
backend and this process's K1 launches. The backend
defaults to NCCL on a card and gloo on the CPU. Any failure exits with a
non-zero code.
"""

from __future__ import annotations

import argparse
import sys
import time


def _local_devices(device: str, n: int) -> list[str]:
    if device != "cuda":
        return [device] * n
    import torch

    count = torch.cuda.device_count()
    return [f"cuda:{j % max(count, 1)}" for j in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--mode", default="render",
                    choices=["render", "train", "both"])
    ap.add_argument("--res", type=int, default=16)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--n-spectrum", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import numpy as np
    import torch.distributed as dist

    from pbrt_tpu_torch.models.path import PathIntegrator
    from pbrt_tpu_torch.ops.smallscene import STATS
    from pbrt_tpu_torch.parallel.multiprocess import (
        global_mesh,
        init_multiprocess,
        render_multiprocess,
        train_step_multiprocess,
    )
    from pbrt_tpu_torch.scenes.cornell import cornell_box

    devices = _local_devices(args.device, args.local_devices)
    init_multiprocess(args.coordinator, args.nprocs, args.pid,
                      device=devices[0], backend=args.backend,
                      timeout_s=args.timeout)
    try:
        assert dist.get_world_size() == args.nprocs
        mesh = global_mesh(devices=devices)
        scene, camera = cornell_box(resolution=(args.res, args.res))
        scene = scene.with_accel()
        integ = PathIntegrator(max_depth=3)
        out = dict(nprocs=args.nprocs, ndev=mesh.size,
                   backend=dist.get_backend())
        kw = dict(n_spectrum=args.n_spectrum, samples_per_pass=args.spp)
        STATS.reset()
        if args.mode in ("render", "both"):
            t0 = time.perf_counter()
            out["img"] = render_multiprocess(scene, camera, integ, mesh,
                                             spp=args.spp, **kw)
            out["seconds"] = time.perf_counter() - t0
        if args.mode in ("train", "both"):
            target = np.full((args.res * args.res, 3), 0.25, np.float32)
            t0 = time.perf_counter()
            loss, grads = train_step_multiprocess(
                scene, camera, integ, target, mesh, spp=args.spp, **kw)
            out.update(loss=loss, train_seconds=time.perf_counter() - t0,
                       **grads)
        out["k1_launches"] = STATS.launches
        np.savez(f"{args.out}.{args.pid}.npz", **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    sys.stdout.write("OK\n")


if __name__ == "__main__":
    main()
