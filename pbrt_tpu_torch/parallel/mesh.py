"""Device meshes and the pixel sharding policy (port of
pbrt_tpu/parallel/mesh.py).

A mesh is an ordered list of devices along one data axis. All parallelism
is data parallel: the scene is replicated on every device, and rays,
pixels or sample indices are split into contiguous chunks in mesh order,
as the reference's PartitionSpec("data") splits them. A device may appear
more than once (two shards on one card). A mesh spanning processes
(parallel/multiprocess.py) also carries this process's rank and the
number of processes; every process holds the same number of devices, and
the global order is host-major.
"""

from __future__ import annotations

import dataclasses

import torch

from ..render import check_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ordered devices of one data axis. `devices` are this process's;
    the global mesh is process_count x len(devices) entries, this
    process's starting at process_index * len(devices)."""

    devices: tuple
    axis: str = "data"
    process_index: int = 0
    process_count: int = 1

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Entries of the whole mesh, across processes."""
        return self.local_size * self.process_count

    @property
    def first_shard(self) -> int:
        """Global index of this process's first entry."""
        return self.process_index * self.local_size


def one_process(mesh: Mesh) -> Mesh:
    """`mesh`, which must not span processes: the single-process paths
    see only their own shards (parallel/multiprocess.py gathers them)."""
    if mesh.process_count != 1:
        raise ValueError("this mesh spans processes: use the functions of "
                         "parallel/multiprocess.py")
    return mesh


def make_mesh(n_devices: int | None = None, axis: str = "data",
              devices=None) -> Mesh:
    """A mesh of the CUDA devices of this process (all, or the first
    n_devices). Without a card it raises: nothing falls back to the CPU.
    `devices` names the entries instead, in order (for example
    ["cpu"] * 8, or ["cuda:0", "cuda:0"] for two shards on one card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "pass devices= to build a mesh of others")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [check_device(d) for d in devices]
    if n_devices is not None:
        if not 0 < n_devices <= len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked of "
                             f"{len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(devices=tuple(devices), axis=axis)


def shard_bounds(n: int, mesh: Mesh) -> list[tuple[int, int]]:
    """[start, stop) of each of this process's entries for n items split
    in contiguous, equal chunks over the whole mesh."""
    if n % mesh.size:
        raise ValueError(f"{n} items do not split evenly over a mesh of "
                         f"{mesh.size} devices")
    k = n // mesh.size
    return [((mesh.first_shard + j) * k, (mesh.first_shard + j + 1) * k)
            for j in range(mesh.local_size)]


def shard_pixels(pixel_array, mesh: Mesh, axis: str = "data") -> list:
    """A flat per-ray / per-pixel array (or the rows of one) split into
    this process's contiguous chunks, each on its mesh device."""
    del axis  # the mesh has one axis
    x = torch.as_tensor(pixel_array)
    return [x[a:b].to(dev)
            for (a, b), dev in zip(shard_bounds(x.shape[0], mesh),
                                   mesh.devices)]


def replicate(tree, mesh: Mesh) -> list:
    """The tree (a scene, a camera, a tensor) on every mesh device, one
    entry per device of the mesh; entries on one device share one copy."""
    copies = {}
    out = []
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = tree.to(dev)
        out.append(copies[dev])
    return out
