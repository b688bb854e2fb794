"""Stats registry + progress reporting.

Port of pbrt_tpu/utils/stats.py. Reference analogue: the declarative
STAT_* macro framework (pbrt-v4 src/pbrt/util/stats.h:88-170) and
ProgressReporter (util/progressreporter.h:44). The per-thread accumulator
merge disappears: device-side counts come back as tensors (e.g. the
integrators' 'rays' stat) and host-side counters are plain Python.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict

import numpy as np
import torch


class _Stats:
    def __init__(self):
        self.counters = defaultdict(float)
        self.distributions = defaultdict(list)

    def add(self, name: str, value: float = 1.0):
        self.counters[name] += value

    def observe(self, name: str, value: float):
        self.distributions[name].append(value)

    def report(self, file=None):
        # Resolve stderr at CALL time (a sys.stderr default argument binds
        # the stream at import, breaking per-test capture swapping).
        file = file if file is not None else sys.stderr
        print("Statistics:", file=file)
        for k in sorted(self.counters):
            print(f"    {k:<46} {self.counters[k]:,.0f}", file=file)
        for k in sorted(self.distributions):
            v = self.distributions[k]
            if v:
                print(
                    f"    {k:<46} avg {sum(v)/len(v):.4g} "
                    f"(min {min(v):.4g}, max {max(v):.4g}, n {len(v)})",
                    file=file,
                )

    def clear(self):
        self.counters.clear()
        self.distributions.clear()


STATS = _Stats()


def stat_counter(name: str, value: float = 1.0):
    STATS.add(name, value)


class ProgressReporter:
    """ETA progress bar (progressreporter.h semantics, stderr-friendly)."""

    def __init__(self, total: int, title: str = "Rendering", quiet=False):
        self.total = max(total, 1)
        self.title = title
        self.done = 0
        self.t0 = time.perf_counter()
        self.quiet = quiet

    def update(self, n: int = 1):
        self.done += n
        if self.quiet:
            return
        frac = min(self.done / self.total, 1.0)
        elapsed = time.perf_counter() - self.t0
        eta = elapsed / max(frac, 1e-6) * (1 - frac)
        bar = "+" * int(40 * frac) + " " * (40 - int(40 * frac))
        print(
            f"\r{self.title}: [{bar}] {100*frac:5.1f}% "
            f"({elapsed:.1f}s|~{eta:.1f}s)",
            end="",
            file=sys.stderr,
            flush=True,
        )
        if frac >= 1.0:
            print(file=sys.stderr)

    def finish(self):
        if self.done < self.total:
            self.update(self.total - self.done)


# --- CHECK_RARE + per-pixel statistics images -------------------------------
# Reference analogues: CHECK_RARE (util/check.h:101 — assert a condition is
# rare, reporting the observed frequency) and the --pixelstats per-pixel
# statistics images (util/stats.cpp StatsWritePixelImages).

_RARE = {}


def check_rare(name: str, condition_mask, max_freq: float = 1e-3):
    """Record how often `condition_mask` (a bool tensor on any device, or
    an array) is true; warn to stderr when the observed frequency exceeds
    max_freq. The mask's count is read back to the host once per call.
    Returns the frequency."""
    m = torch.as_tensor(condition_mask)
    hits, total = int(torch.count_nonzero(m)), int(m.numel())
    h0, t0, mf = _RARE.get(name, (0, 0, max_freq))
    _RARE[name] = (h0 + hits, t0 + total, max_freq)
    freq = (h0 + hits) / max(t0 + total, 1)
    if freq > max_freq and (t0 + total) > 1000:
        print(
            f"CHECK_RARE '{name}': frequency {freq:.2e} exceeds "
            f"{max_freq:.1e} ({h0 + hits}/{t0 + total})",
            file=sys.stderr,
        )
    return freq


def rare_report() -> dict:
    """All CHECK_RARE frequencies observed so far."""
    return {
        k: {"hits": h, "total": t, "freq": h / max(t, 1), "max_freq": mf}
        for k, (h, t, mf) in _RARE.items()
    }


class PixelStats:
    """Accumulate named per-pixel statistic images (the reference's
    --pixelstats: one EXR channel per STAT_PIXEL counter), on the host."""

    def __init__(self, nx: int, ny: int):
        self.nx, self.ny = nx, ny
        self.images = {}

    def add(self, name: str, pixel_ids, values=None):
        """Scatter-accumulate values (default 1) at flat pixel ids (tensors
        on any device, read back once, or arrays)."""
        img = self.images.setdefault(
            name, np.zeros((self.ny * self.nx,), np.float64)
        )
        pid = _host(pixel_ids).reshape(-1)
        v = (
            np.ones_like(pid, np.float64)
            if values is None else _host(values).astype(np.float64).reshape(-1)
        )
        np.add.at(img, np.clip(pid, 0, img.size - 1), v)

    def write(self, path: str):
        """Write all stat planes to one EXR (channel per statistic)."""
        from ..io.image import write_exr

        names = sorted(self.images)
        chans = np.stack(
            [self.images[n].reshape(self.ny, self.nx) for n in names], -1
        ).astype(np.float32)
        write_exr(path, chans, channel_names=names)
        return names


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
