"""Render checkpoint and resume at chunk boundaries (port of
pbrt_tpu/films/checkpoint.py). The film's state (the rgb sum, the samples
done, the target and the seed) is the checkpoint, saved as an .npz after
every chunk, so a stopped render continues where it stopped: sample
indices are the random numbers' coordinates, so the resumed render is the
one-shot one."""

from __future__ import annotations

import os

import numpy as np
import torch


def save_checkpoint(path: str, rgb_sum, spp_done: int, total_spp: int,
                    seed: int) -> None:
    np.savez(path, rgb_sum=rgb_sum.detach().cpu().numpy(), spp_done=spp_done,
             total_spp=total_spp, seed=seed)


def load_checkpoint(path: str, *, device):
    """(rgb_sum on `device`, spp_done, total_spp, seed)."""
    z = np.load(path)
    return (torch.from_numpy(z["rgb_sum"]).to(device), int(z["spp_done"]),
            int(z["total_spp"]), int(z["seed"]))


def render_resumable(scene, camera, integrator, spp: int, checkpoint_path: str,
                     seed: int = 0, samples_per_pass: int = 4,
                     chunk_spp: int = 8, *, device, **kw):
    """Chunked render that checkpoints after every chunk and resumes from
    an existing checkpoint file. Returns the finished (ny, nx, 3) image."""
    from ..render import render

    nx, ny = camera.resolution
    if os.path.exists(checkpoint_path):
        rgb_sum, done, total, seed = load_checkpoint(checkpoint_path,
                                                     device=device)
        if total != spp:
            raise ValueError(f"the checkpoint {checkpoint_path!r} belongs to a "
                             f"{total}-spp render, not {spp}")
    else:
        rgb_sum = torch.zeros((ny, nx, 3), dtype=torch.float32, device=device)
        done = 0
    while done < spp:
        cur = min(chunk_spp, spp - done)
        cur -= cur % min(samples_per_pass, cur)
        img = render(scene, camera, integrator, spp=cur, seed=seed,
                     samples_per_pass=min(samples_per_pass, cur),
                     sample_offset=done, total_spp=spp, device=device, **kw)
        rgb_sum = rgb_sum + img * cur
        done += cur
        save_checkpoint(checkpoint_path, rgb_sum, done, spp, seed)
    return rgb_sum / spp
