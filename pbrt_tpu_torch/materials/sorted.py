"""Tag-sorted shading dispatch (port of pbrt_tpu/materials/sorted.py).

The lockstep select chain (materials/bxdf.py) evaluates every family the
scene references on every lane, so a scene with a coated family charges
each diffuse lane for two layered walks. The wavefront renderer queues
each hit by material instead (surfscatter.cpp:39-58). The reference does
it with fixed-size tiles under `lax.map` / `lax.switch`; here the lanes
are ordered by kind with a stable argsort, each family runs once on its
one contiguous segment with only its own link switched on, and the
outputs go back to ray order through the inverse permutation.

Every BxDF op is per lane (the layered walk is keyed on direction bits,
not on the lane) and eager PyTorch does not fuse, so the result is
bit-equal to the lockstep chain's. The segment sizes are read on the host:
one device-to-host copy per call, i.e. per bounce.
"""

from __future__ import annotations

import torch

from ..core.take import take
from .bxdf import FAMILY_FLAGS, FLAGS
from .buffers import MAT_DIFFUSE

# Entries of the surface_params dict that are global tables, never per ray.
_GLOBAL_KEYS = ("measured_coeffs", "measured_scale")


def possible_families(params) -> list[int]:
    """Kinds with a link switched on in params, diffuse first."""
    return [MAT_DIFFUSE] + [kind for kind, flag in FAMILY_FLAGS.items()
                            if params.get(flag)]


def _restrict(params, fam: int):
    """params with the link flags narrowed to one family's. A subsurface
    lane is rewritten to the normalized-Fresnel kind (13) before the
    dispatch; kind 13's segment keeps the subsurface flag, which gates
    that lobe. The reference's tiles have no branch of their own for kind
    13 and run such a tile through the full chain, which gives those
    lanes the same values (every op is per lane)."""
    out = dict(params)
    keep = FAMILY_FLAGS.get(fam)
    for flag in FLAGS:
        out[flag] = flag == keep
    return out


def shade_sorted(params, ops, fn, tile: int = 8192):
    """fn(params, ops) computed family by family over kind-sorted lanes.

    params: the surface_params dict (per-ray tensors with leading dim N,
    global tables and the `any_*` flags); ops: a dict of further per-ray
    tensors (leading dim N); fn(params, ops) -> a dict (nested dicts
    allowed) of per-ray tensors. Returns fn's outputs in the original ray
    order, bit-equal to fn(params, ops). Batches of at most `tile` lanes,
    or with one family, run fn directly (the reference's rule). A lane
    whose kind has no link of its own (a miss reads material 0, which the
    geometry may not reference) runs in a segment with every flag of
    params, the chain it gets from fn(params, ops).
    """
    kind = params["kind"]
    n = int(kind.shape[0])
    fams = possible_families(params)
    if len(fams) <= 1 or n <= tile:
        return fn(params, ops)

    perm = torch.argsort(kind, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, dtype=perm.dtype, device=perm.device)
    kinds_sorted = kind[perm]
    present, counts = torch.unique_consecutive(kinds_sorted,
                                               return_counts=True)
    # The one host read of the dispatch: which kinds, how many lanes each.
    segments = list(zip(present.tolist(), counts.tolist()))

    per_ray = {k: v for k, v in params.items()
               if k not in _GLOBAL_KEYS and isinstance(v, torch.Tensor)
               and v.ndim >= 1 and v.shape[0] == n}
    static = {k: v for k, v in params.items() if k not in per_ray}
    params_s = {k: take(v, perm) for k, v in per_ray.items()}
    ops_s = {k: take(v, perm) for k, v in ops.items()}

    outs = []
    start = 0
    for fam, count in segments:
        sl = slice(start, start + count)
        flags = _restrict(static, fam) if fam in fams else static
        outs.append(fn({**flags, **{k: v[sl] for k, v in params_s.items()}},
                       {k: v[sl] for k, v in ops_s.items()}))
        start += count

    def merge(parts):
        if isinstance(parts[0], dict):
            return {k: merge([p[k] for p in parts]) for k in parts[0]}
        return take(torch.cat(parts), inv)

    return merge(outs)
