#!/usr/bin/env python
"""Render the JAX reference's render-CLI golden, which the PyTorch port's
CLI (pbrt_tpu_torch/tools/pbrt_render.py) is held against.

Runs pbrt_tpu.tools.pbrt_render.main on the CPU on the three scenes of
tests/torch_port_cli.py (tests/test_tools.py's), at seed 0 and the
reference's default 32 wavelength lanes, and writes
tests/data/torch_port/cli16.npz: the image case's EXR image, the GBuffer
case's `--gbuffer --spectral-buckets 6` channels and the `--debugstart
3,5,1` record (see tests/torch_port_cli.py for the keys). The tests read
this file and never run the reference's CLI, which jits its integrator.

Usage (from the repository root; ~1 minute):
    JAX_PLATFORMS=cpu python scripts/make_torch_port_golden_cli.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.spectrum import N_SPECTRUM
    from pbrt_tpu.io.image import read_exr
    from pbrt_tpu.tools.pbrt_render import main as cli

    from tests import torch_port_cli as tc

    if N_SPECTRUM != 32:
        raise SystemExit(f"unset PBRT_TPU_NSPECTRUM (got {N_SPECTRUM} lanes)")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        scene = tc.write_scene(tmp, "image.pbrt", tc.IMAGE_SCENE)
        exr = os.path.join(tmp, "image.exr")
        if cli([scene, "--outfile", exr, *tc.IMAGE_ARGS]) != 0:
            raise SystemExit("the image case failed")
        img, chans, _ = read_exr(exr)
        out["image"] = np.stack([img[..., chans.index(c)] for c in "RGB"], -1)

        scene = tc.write_scene(tmp, "gbuffer.pbrt", tc.GBUFFER_SCENE)
        exr = os.path.join(tmp, "g.exr")
        if cli([scene, "--outfile", exr, *tc.GBUFFER_ARGS]) != 0:
            raise SystemExit("the GBuffer case failed")
        out["aov"], chans, _ = read_exr(os.path.join(tmp, "g_aov.exr"))
        out["aov_channels"] = np.asarray(chans)
        out["spectral"], _, _ = read_exr(os.path.join(tmp, "g_spectral.exr"))

        scene = tc.write_scene(tmp, "debug.pbrt", tc.DEBUG_SCENE)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if cli([scene, *tc.DEBUG_ARGS]) != 0:
                raise SystemExit("the --debugstart case failed")
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        for key in tc.DEBUG_KEYS:
            out["debug_" + key] = np.asarray(rec[key])
    np.savez_compressed(tc.GOLDEN, **out)
    print(tc.GOLDEN, {k: v.shape for k, v in out.items()})


if __name__ == "__main__":
    main()
