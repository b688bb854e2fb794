"""Multi-process (multi-host) rendering and training over torch.distributed
(port of pbrt_tpu/parallel/multiprocess.py).

One process per host calls `init_multiprocess` with a `tcp://`
coordinator, its rank and the number of processes. `global_mesh` then
joins every process's local devices into one mesh, host-major: process r
holds entries r * L .. r * L + L - 1 of a mesh of world * L entries.
Pixels are split over the whole mesh in contiguous chunks, as in
parallel/mesh.py, so each process renders its own rows of the image.

Every process ends with the same image and the same gradients, bit for
bit: the processes all-gather their film shards, or their per-shard loss
and gradients, in rank order, and each sums the gathered partials in
global mesh order itself (an all_reduce could reassociate the sums
differently from one layout to another). The results are those of one
process with the same mesh entries, since a pixel's radiance does not
depend on the layout.

The collectives run on the backend's device: gloo (the default for CPU
devices) on CPU tensors, so a process whose shards are on a card stages
them through the host; NCCL (the default for CUDA devices) on the
process's card.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from ..core import spectrum
from ..models.path import get_leaf
from ..render import check_device
from .mesh import Mesh, replicate, shard_pixels
from .render import accumulate, render_tile_shards
from .train import loss_and_grad

TRAIN_LEAVES = {"albedo_coeffs": "materials.albedo_coeffs",
                "area_scale": "lights.area_scale"}


def init_multiprocess(coordinator_address: str, num_processes: int,
                      process_id: int, *, device="cuda",
                      backend: str | None = None,
                      timeout_s: float = 300.0) -> None:
    """Join the process group (one call per process). `device` is where
    this process renders; the backend defaults to NCCL for a CUDA device
    (whose card becomes this process's current one) and gloo otherwise.
    A CUDA device without a card raises."""
    device = check_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(
        backend, init_method=address, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


def comm_device() -> torch.device:
    """The device the process group's collectives take tensors on."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh(axis: str = "data", devices=None) -> Mesh:
    """The mesh over every process's devices, host-major. `devices` are
    this process's entries (default: its CUDA devices); every process
    must hold as many."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_mesh: no CUDA device is available; "
                               "pass devices=")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(check_device(d) for d in devices)
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(devices))
    if len(set(counts)) != 1:
        raise ValueError(f"every process needs as many devices: {counts}")
    return Mesh(devices=devices, axis=axis, process_index=dist.get_rank(),
                process_count=dist.get_world_size())


def _gather_rows(local: torch.Tensor) -> torch.Tensor:
    """Every process's `local` rows (the same shape on each), in rank
    order, on every process (the comm device)."""
    local = local.to(comm_device()).contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    return torch.cat(parts)


def render_multiprocess(scene, camera, integrator, mesh: Mesh | None = None,
                        spp: int = 4, seed: int = 0,
                        n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT,
                        samples_per_pass: int = 1) -> np.ndarray:
    """Pixel-sharded render over the global mesh. Returns the whole
    (ny, nx, 3) image as numpy on every process (an all-gather of the
    film shards)."""
    if mesh is None:
        mesh = global_mesh()
    nx, ny = camera.resolution
    shards = render_tile_shards(scene, camera, integrator, mesh, spp, seed,
                                n_spectrum, samples_per_pass)
    local = torch.cat([s.to(comm_device()) for s in shards])
    return _gather_rows(local).cpu().numpy().reshape(ny, nx, 3)


def train_step_multiprocess(scene, camera, integrator, target_rgb,
                            mesh: Mesh | None = None, spp: int = 1,
                            seed: int = 0,
                            n_spectrum: int = spectrum.N_SPECTRUM_DEFAULT,
                            samples_per_pass: int = 1):
    """One pixel-sharded loss and gradient step over the global mesh: the
    loss is sum((rgb - target)^2) over every pixel of the image, over its
    3 * npix values, for the albedo coefficients and the area lights'
    scales. Returns (loss, {"albedo_coeffs", "area_scale"}) as numpy, the
    same on every process."""
    if mesh is None:
        mesh = global_mesh()
    nx, ny = camera.resolution
    npix = nx * ny
    target = torch.as_tensor(np.asarray(target_rgb, np.float32)).reshape(
        npix, 3)
    pixels = shard_pixels(torch.arange(npix, dtype=torch.int64), mesh)
    targets = shard_pixels(target, mesh)
    rows = []
    for sc, cam, pix, tgt in zip(replicate(scene, mesh),
                                 replicate(camera, mesh), pixels, targets):
        loss, grads = loss_and_grad(
            sc, lambda s: accumulate(s, cam, integrator, pix, range(spp),
                                     seed, n_spectrum, samples_per_pass) / spp,
            tgt, TRAIN_LEAVES.values(), npix * 3)
        # One shard's [loss, grad of each TRAIN_LEAVES leaf], flat.
        rows.append(torch.cat([loss.reshape(1)] + [
            grads[p].reshape(-1) for p in TRAIN_LEAVES.values()
        ]).to(comm_device()))
    local = torch.stack(rows)
    partials = _gather_rows(local)  # (mesh.size, K), global mesh order
    total = partials[0]
    for row in partials[1:]:
        total = total + row
    total = total.cpu().numpy()
    out, at = {}, 1
    for k, p in TRAIN_LEAVES.items():
        shape = tuple(get_leaf(scene, p).shape)
        size = int(np.prod(shape))
        out[k] = total[at:at + size].reshape(shape)
        at += size
    return float(total[0]), out
