"""lenstool: lens-file operations for realistic/omni cameras.

Port of pbrt_tpu/tools/lenstool.py: `info` traces through the port's
cameras/lens.py::trace_through_stack on --device (the card unless the
caller passes cpu); the rest is JSON and numpy on the host.

Reference analogue: pbrt-v4 src/pbrt/cmd/lenstool.cpp (convert,
insertmicrolens). Commands:

  convert <in.dat> <out.json> [--inputscale N] [--implicitdefaults]
      Convert a classic 4-column pbrt lens .dat (radius, thickness, ior,
      aperture-diameter) into the omni-style .json schema (surfaces with
      radius/thickness/semi_aperture/ior spectral table/conic_constant).

  insertmicrolens <lens.json> <microlens.json> <out.json>
      [--xdim N] [--ydim N] [--filmwidth MM] [--filmheight MM]
      [--filmtolens MM]
      Embed a microlens-array block (dimensions + per-lenslet offsets +
      lenslet surfaces) into a main-lens .json.

  info <lens.dat|lens.json> [--device cuda|cpu]
      Print surface table, focal length and back focal distance estimated
      by paraxial ray tracing through the stack.

The emitted .json round-trips through cameras.realistic.load_lens_json.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# The reference emits an ior table over the full spectral range; mirror the
# sampled-spectrum endpoints (util/spectrum.h Lambda_min/max).
_LAMBDA_MIN = 360.0
_LAMBDA_MAX = 830.0
_N_SPECTRUM = 4

_IDENTITY = [[1.0 if r == c else 0.0 for r in range(4)] for c in range(4)]


def _read_dat(path):
    """Read a pbrt lens .dat: comment header lines then 4 floats/surface.
    Returns (name, description, rows (N,4))."""
    name, desc, vals = "", "", []
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        t = line.strip()
        if not t:
            continue
        if t.startswith("#"):
            if i == 0:
                name = t[1:].strip()
            else:
                desc += t[1:].strip() + "\n"
            continue
        vals.extend(float(x) for x in t.split())
    if len(vals) % 4 == 1:
        # pbrt-v2-spectral files carry a leading focal length; drop it
        # (lenstool.cpp does the same with a warning).
        print("lenstool: dropping leading focal-length value "
              "(pbrt-v2-spectral style file)", file=sys.stderr)
        vals = vals[1:]
    if len(vals) % 4 != 0:
        raise SystemExit(
            f"lenstool: {path}: element count {len(vals)} is not a "
            "multiple of 4"
        )
    rows = np.asarray(vals, np.float64).reshape(-1, 4)
    return name, desc.strip(), rows


def cmd_convert(args):
    name, desc, rows = _read_dat(args.input)
    rows = rows * [args.inputscale, args.inputscale, 1.0, args.inputscale]
    wavelengths = [
        _LAMBDA_MIN + (_LAMBDA_MAX - _LAMBDA_MIN) * i / (_N_SPECTRUM - 1)
        for i in range(_N_SPECTRUM)
    ]
    surfaces = []
    for radius, thickness, ior, ap in rows:
        s = {
            "radius": radius,
            "thickness": thickness,
            "semi_aperture": ap / 2.0,
        }
        if args.implicitdefaults:
            s["ior"] = ior
        else:
            s["ior"] = [wavelengths, [ior] * _N_SPECTRUM]
            s["conic_constant"] = 0.0
            s["transform"] = _IDENTITY
        surfaces.append(s)
    out = {"name": name, "description": desc, "surfaces": surfaces}
    with open(args.output, "w") as f:
        json.dump(out, f, indent=4)
        f.write("\n")
    print(f"Input file: {args.input}, Output file: {args.output}; "
          f"{len(surfaces)} surfaces")


def cmd_insertmicrolens(args):
    with open(args.lens) as f:
        jlens = json.load(f)
    with open(args.microlens) as f:
        jmicro = json.load(f)
    if jmicro.get("microlens"):
        raise SystemExit(
            "lenstool: microlens file has its own microlens block"
        )
    mlname = jmicro.get("name", "")
    jlens["name"] = jlens.get("name", "") + " w/ microlens " + mlname
    jlens["description"] = (
        jlens.get("description", "")
        + "\nWith added microlens " + mlname
        + (":\n" + jmicro["description"] if jmicro.get("description") else "")
    )
    jlens["microlens"] = {
        "dimensions": [args.xdim, args.ydim],
        "surfaces": jmicro["surfaces"],
        "offsets": [[0.0, 0.0] for _ in range(args.xdim * args.ydim)],
    }
    with open(args.output, "w") as f:
        json.dump(jlens, f, indent=4)
        f.write("\n")
    print(f"{args.lens} + {args.microlens} = {args.output}")


def cmd_info(args):
    import torch

    from ..cameras.lens import load_lens_file, trace_through_stack
    from ..cameras.realistic import load_lens_json
    from ..render import check_device

    device = check_device(args.device)

    if args.input.endswith(".json"):
        stack, micro = load_lens_json(args.input)
    else:
        stack = load_lens_file(args.input)
        micro = None
    vz = stack.vertex_z.numpy()
    rad = stack.radius.numpy()
    ap = np.sqrt(stack.aperture2.numpy())
    print(f"{args.input}: {stack.n_surfaces} surfaces")
    print(f"{'z(mm)':>10} {'radius':>10} {'semi-ap':>10}")
    for i in range(stack.n_surfaces):
        print(f"{vz[i]:10.4f} {rad[i]:10.4f} {ap[i]:10.4f}")
    # Paraxial focal length: trace a near-axis ray parallel to the optical
    # axis from the film side; the effective focal length |h / tan(exit
    # angle)| is direction-independent for a stack in air.
    h = float(ap.min()) * 0.02
    o = torch.tensor([[h, 0.0, -1.0]], dtype=torch.float32, device=device)
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float32, device=device)
    o2, d2, ok = trace_through_stack(stack.to(device), o, d)
    o2, d2 = o2[0].cpu().numpy(), d2[0].cpu().numpy()
    if bool(ok[0]) and abs(d2[0]) > 1e-12:
        f_eff = abs(h / d2[0]) * abs(d2[2])
        t_axis = -o2[0] / d2[0]
        z_focus = o2[2] + t_axis * d2[2]
        print(f"paraxial effective focal length ~ {f_eff:.3f} mm")
        print(f"front focal point at z ~ {z_focus:.3f} mm "
              f"(film plane z = 0)")
    if micro is not None:
        print(f"microlens array: {micro.dims[0]}x{micro.dims[1]}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="lenstool")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--inputscale", type=float, default=1.0)
    c.add_argument("--implicitdefaults", action="store_true")
    c.set_defaults(fn=cmd_convert)

    m = sub.add_parser("insertmicrolens")
    m.add_argument("lens")
    m.add_argument("microlens")
    m.add_argument("output")
    m.add_argument("--xdim", type=int, default=16)
    m.add_argument("--ydim", type=int, default=16)
    m.add_argument("--filmwidth", type=float, default=20.0)
    m.add_argument("--filmheight", type=float, default=20.0)
    m.add_argument("--filmtolens", type=float, default=50.0)
    m.set_defaults(fn=cmd_insertmicrolens)

    i = sub.add_parser("info")
    i.add_argument("input")
    i.add_argument("--device", default="cuda",
                   help="torch device of the paraxial trace (default cuda)")
    i.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    if args.cmd == "convert" and args.inputscale == 0:
        raise SystemExit("--inputscale value must be non-zero")
    return args.fn(args)


if __name__ == "__main__":
    main()
