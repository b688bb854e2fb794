"""Staged compaction of masked fixed-point walks (port of
pbrt_tpu/ops/compact.py), in eager form.

The volumetric walks (models/volpath.py: delta tracking and ratio
tracking) are masked loops whose live set decays fast. The reference's
docstring reports, for its cloud bench on its own hardware, 45% of rays
entering the medium, ~6% still walking after 28 steps and none by 48.
The reference runs the walk in stages of a fixed plan (default_stages),
gathering the still-walking lanes to the front of narrower batches
between stages, with a capacity guard.

Here every stage boundary reads the live count on the host and gathers
exactly the live lanes (torch.nonzero), as materials/sorted.py reads its
segment sizes: no capacity, so no overflow and no guard. The body runs on
the gathered batch and the results are scattered back. The renderer's RNG
is stateless (a draw depends on (pixel, sample, dimension), never on a
lane's position) and every op of a walk body is per lane, so a compacted
lane computes bit for bit what the lockstep loop computes.

The reference's while_loop ends a stage as soon as no lane is live, which
in eager PyTorch is a device-to-host read per step. Both walk bodies leave
finished lanes unchanged (every update is masked by the walk's own live
flag), so extra steps change no bit and the exit may be read less often:
here it is read every CHECK_EVERY steps and at each stage end.

Draws: a body may take its step's random numbers from `draws(inputs, it0,
m)`, called once per run of m <= CHECK_EVERY steps on the current batch,
which returns a (n, m, ...) tensor; the body gets its step's slice. One
batched pcg4d hash then replaces m per-step hashes (~100 int64 ops each
in core/rng.py's uint32 emulation).
"""

from __future__ import annotations

import torch


class ReadStats:
    """Device-to-host reads of the walks' live sets: `reads` goes up by
    one at each (a stage boundary's count, an exit check)."""

    def __init__(self):
        self.reads = 0

    def reset(self):
        self.reads = 0


STATS = ReadStats()

# Steps between two reads of the live set. A read synchronises the host
# with the device: in a launch-bound walk (~100 launches a step) it stalls
# the launch queue once per 8 steps, while a dead batch runs at most 7
# masked steps that change nothing. 8 also bounds the batched draws to
# (n, 16) per run.
CHECK_EVERY = 8


def default_stages(max_steps: int):
    """Stage plan (width divisor, iterations) summing to max_steps, the
    reference's, shaped to its measured decay of the medium walks. The
    eager loop compacts at each stage boundary to exactly the live
    lanes, so only the iteration counts matter here."""
    k0 = max(1, max_steps // 8)
    k1 = max(1, max_steps // 5)
    k2 = max(1, max_steps // 4)
    k3 = max_steps - k0 - k1 - k2
    plan = [(1, k0), (2, k1), (4, k2)]
    if k3 > 0:
        plan.append((16, k3))
    return plan


def _steps(body, inputs, state, it0, m, draws):
    u = draws(inputs, it0, m) if draws is not None else None
    for j in range(m):
        state = body(inputs, it0 + j, state, None if u is None else u[:, j])
    return state


def _run(body, inputs, state, mask_of, it0, iters, draws):
    """`iters` steps from step it0, ending early at a read that finds no
    live lane."""
    it, end = it0, it0 + iters
    while it < end:
        m = min(CHECK_EVERY, end - it)
        state = _steps(body, inputs, state, it, m, draws)
        it += m
        if it < end:
            STATS.reads += 1
            if not bool(torch.any(mask_of(state))):
                break
    return state


def masked_loop(body, inputs, state, max_steps: int, draws=None):
    """Exactly max_steps steps of `state = body(inputs, it, state, u)` over
    the whole batch, with no host read: the differentiable walks' loop
    (the reference's fixed-length scan)."""
    it = 0
    while it < max_steps:
        m = min(CHECK_EVERY, max_steps - it)
        state = _steps(body, inputs, state, it, m, draws)
        it += m
    return state


def staged_masked_loop(body, inputs, state, mask_of, max_steps: int,
                       draws=None, compact: bool = True, stages=None):
    """Run `state = body(inputs, it, state, u)` until mask_of(state) is all
    False or max_steps steps, compacting to the live lanes at each stage
    boundary (compact=False: the lockstep loop, full width throughout,
    with the same exit reads).

    stages: the reference's plan of (width divisor, steps) pairs, by
    default `default_stages(max_steps)`. Its steps set the stage
    boundaries and, summed, the steps in all; its divisors are not read,
    since each stage is as wide as its live lanes. The body changes only
    live lanes, so the boundaries change no result.

    body: (inputs, it, state, u) -> state; it changes only lanes where
        mask_of(state) (the masked-update discipline), u is the step's
        slice of draws(...) or None.
    inputs: dict of per-ray constants (leading dim N) the body reads.
    state: dict of per-ray loop state (leading dim N).
    mask_of: state -> (N,) bool, the still-walking mask.
    """
    if stages is None:
        stages = default_stages(max_steps) if compact else [(1, max_steps)]
    elif not compact:
        stages = [(1, sum(max(k, 0) for _, k in stages))]
    it = 0
    for _, iters in stages:
        if iters <= 0:
            continue
        if not compact:
            state = _run(body, inputs, state, mask_of, it, iters, draws)
        else:
            # The stage boundary's host read: exactly the live lanes.
            STATS.reads += 1
            idx = torch.nonzero(mask_of(state)).squeeze(1)
            if idx.numel() == 0:
                break
            part_in = {k: v[idx] for k, v in inputs.items()}
            part = _run(body, part_in, {k: v[idx] for k, v in state.items()},
                        mask_of, it, iters, draws)
            state = {k: v.index_copy(0, idx, part[k])
                     for k, v in state.items()}
        it += iters
    return state
