#!/usr/bin/env python3
"""Where one instanced-field forward pass of the PyTorch port spends its
device time.

The pass is the instanced field's configuration
(tests/data/torch_port/instanced_field.pbrt through the port's parser: 37
instances, 17,191 entries, K3; 512x512, 4 samples per pixel in the pass,
depth 5, no Russian roulette, 8 lanes) on one CUDA device, after a warm-up
pass; the pass is chip_smoke.make_pass, the one chip_smoke.py times.

  kernels  torch.profiler over one pass: summed device kernel time, the
           device busy share, kernel launches, K3's kernel time and the top
           kernels (full table: OUT_DIR/profile_instanced.txt)
  layers   CUDA events around each top-level call of the port's layers
           (scripts/profile_torch_pass.py's wrappers; "intersect_*" is
           accel.api.closest / any_hit: the ray sort, K3 and, for closest,
           resolve_tri_attrs_inst)

Prints one JSON line per view.

Usage (from the repository root, on a machine with a CUDA device):
    python3 scripts/profile_torch_instanced.py [OUT_DIR]   # default: .
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_instanced: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from chip_smoke import make_pass
    from pbrt_tpu_torch.io.parser import load_pbrt_string
    from profile_torch_killeroo import kernel_view, layer_view
    from tests.torch_port_instanced import field_text, write_field_meshes

    out_dir = sys.argv[1] if len(sys.argv) > 1 else "."
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="instanced_field_") as tmp:
        write_field_meshes("pbrt_tpu_torch", tmp)
        scene, camera, _ = load_pbrt_string(field_text(), tmp, device=dev)
    render_pass = make_pass(scene, camera, camera.resolution[0], 4, 8)
    print(json.dumps(kernel_view(render_pass, out_dir, kernel="sweep_kernel",
                                 key="k3_ms", table="profile_instanced.txt")),
          flush=True)
    print(json.dumps(layer_view(render_pass)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
