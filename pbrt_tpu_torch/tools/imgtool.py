"""imgtool: image swiss-army knife.

Port of pbrt_tpu/tools/imgtool.py: numpy on the host, the port's image
readers and writers; makeequiarea fits and evaluates the environment map
in torch on --device (the card unless the caller passes cpu).
Reference analogue: pbrt-v4 src/pbrt/cmd/imgtool.cpp (2,685 LoC).
Subcommands: convert, diff, error, denoise, makesky, average, assemble,
falsecolor, makeequiarea, whitebalance, cat, scalenormalmap, makeemitters,
bloom. Usage:

    python -m pbrt_tpu_torch.tools.imgtool <command> [args...]
"""

from __future__ import annotations

import argparse
import glob as globmod
import json
import sys

import numpy as np

from ..core import colorspace
from ..io.image import read_exr, read_pfm, write_exr, write_pfm, write_png


def _read(path: str) -> np.ndarray:
    if path.endswith(".exr"):
        img, chans, _ = read_exr(path)
        if set("RGB") <= set(chans):
            return np.stack(
                [img[..., chans.index(c)] for c in "RGB"], axis=-1
            )
        return img
    if path.endswith(".pfm"):
        return read_pfm(path)
    raise ValueError(f"unsupported input format: {path}")


def _write(path: str, img: np.ndarray) -> None:
    if path.endswith(".exr"):
        write_exr(path, img)
    elif path.endswith(".pfm"):
        write_pfm(path, img)
    elif path.endswith(".png"):
        write_png(path, colorspace.srgb_encode(np.clip(img, 0, 1)))
    elif path.endswith(".qoi"):
        from ..io.image import write_qoi

        write_qoi(path, colorspace.srgb_encode(np.clip(img, 0, 1)))
    else:
        raise ValueError(f"unsupported output format: {path}")


def cmd_convert(args):
    img = _read(args.input)
    if args.exposure != 1.0:
        img = img * args.exposure
    if args.tonemap:
        img = img / (1.0 + img)  # simple Reinhard
    _write(args.output, img)


def cmd_diff(args):
    a = _read(args.image)
    b = _read(args.reference)
    assert a.shape == b.shape, (a.shape, b.shape)
    mse = float(np.mean((a - b) ** 2))
    mrse = float(np.mean((a - b) ** 2 / (b * b + 1e-2)))
    mae = float(np.mean(np.abs(a - b)))
    out = {"mse": mse, "mrse": mrse, "mae": mae}
    if getattr(args, "flip", False):
        from ..utils.flip import mean_flip

        out["flip"] = mean_flip(b, a, ppd=args.ppd)
    print(json.dumps(out))
    if args.outfile:
        _write(args.outfile, np.abs(a - b))
    return 0 if (args.metric_limit is None or mse <= args.metric_limit) else 1


def cmd_error(args):
    """Convergence analysis vs a reference (cmd/imgtool.cpp:146-248
    `error`): per-image MSE/MRSE/MAE (+FLIP) and the fitted log-log
    convergence order across the image sequence."""
    ref = _read(args.reference)
    rows = []
    for pth in args.inputs:
        img = _read(pth)
        assert img.shape == ref.shape, (pth, img.shape, ref.shape)
        row = {
            "file": pth,
            "mse": float(np.mean((img - ref) ** 2)),
            "mrse": float(np.mean((img - ref) ** 2 / (ref * ref + 1e-2))),
            "mae": float(np.mean(np.abs(img - ref))),
        }
        if args.flip:
            from ..utils.flip import mean_flip

            row["flip"] = mean_flip(ref, img, ppd=args.ppd)
        rows.append(row)
    out = {"images": rows}
    if len(rows) >= 2:
        # Convergence order: slope of log(mse) vs log(sample index 1..N)
        # (equal-work spacing; pass files in increasing-spp order).
        x = np.log(np.arange(1, len(rows) + 1, dtype=np.float64))
        y = np.log(np.maximum([r["mse"] for r in rows], 1e-12))
        slope = float(np.polyfit(x, y, 1)[0])
        out["mse_convergence_order"] = -slope
    print(json.dumps(out))
    if args.metric_limit is not None:
        return 0 if rows[-1]["mse"] <= args.metric_limit else 1
    return 0


def cmd_denoise(args):
    """Auxiliary-guided denoiser (imgtool denoise; the GPU build delegates
    to the OptiX denoiser — here an open cross-bilateral filter guided by
    the renderer's own GBuffer AOVs; utils/denoise.py)."""
    from ..utils.denoise import denoise

    img = _read(args.input)
    albedo = normal = depth = None
    if args.aov:
        aux, chans, _ = read_exr(args.aov)

        def grab(names):
            if all(n in chans for n in names):
                return np.stack(
                    [aux[..., chans.index(n)] for n in names], -1
                )
            return None

        albedo = grab(["AlbedoR", "AlbedoG", "AlbedoB"])
        normal = grab(["Nx", "Ny", "Nz"])
        dz = grab(["Depth"])
        depth = dz[..., 0] if dz is not None else None
    out = denoise(
        img, albedo=albedo, normal=normal, depth=depth,
        radius=args.radius,
    )
    _write(args.output, out)


def cmd_makesky(args):
    """Analytic sun/sky environment map (imgtool makesky). Default model:
    Hosek-Wilkie spectral (the dataset the reference vendors,
    src/ext/skymodel); --model preetham keeps the older analytic model."""
    if args.model == "hosek":
        from ..utils.sky import make_sky_latlong_hosek

        img = make_sky_latlong_hosek(
            res_y=args.resolution,
            sun_elevation_deg=args.elevation,
            sun_azimuth_deg=args.azimuth,
            turbidity=args.turbidity,
            albedo=args.albedo,
        )
    else:
        from ..utils.sky import make_sky_latlong

        img = make_sky_latlong(
            res_y=args.resolution,
            sun_elevation_deg=args.elevation,
            sun_azimuth_deg=args.azimuth,
            turbidity=args.turbidity,
            sun_intensity=args.sun_intensity,
            sun_half_angle=args.sun_half_angle,
        )
    _write(args.output, img)


def cmd_average(args):
    imgs = [_read(p) for p in args.inputs]
    _write(args.output, np.mean(np.stack(imgs), axis=0))


def cmd_assemble(args):
    """Merge crop-window tiles written as EXRs with tileX/tileY metadata."""
    tiles = []
    for p in args.inputs:
        img, chans, meta = read_exr(p)
        rgb = np.stack([img[..., chans.index(c)] for c in "RGB"], axis=-1)
        tiles.append((int(meta.get("tileX", 0)), int(meta.get("tileY", 0)), rgb))
    w = max(x + t.shape[1] for x, _, t in tiles)
    h = max(y + t.shape[0] for _, y, t in tiles)
    out = np.zeros((h, w, 3), np.float32)
    for x, y, t in tiles:
        out[y : y + t.shape[0], x : x + t.shape[1]] = t
    _write(args.output, out)


def cmd_falsecolor(args):
    img = _read(args.input)
    lum = img.mean(axis=-1) if img.ndim == 3 else img
    lo, hi = (args.min, args.max) if args.max else (
        float(lum.min()), float(np.percentile(lum, 99.5)) or 1.0
    )
    t = np.clip((lum - lo) / max(hi - lo, 1e-9), 0, 1)
    # Viridis-ish 5-stop ramp.
    stops = np.asarray(
        [[0.27, 0.00, 0.33], [0.23, 0.32, 0.55], [0.13, 0.57, 0.55],
         [0.37, 0.79, 0.38], [0.99, 0.91, 0.14]]
    )
    x = t * (len(stops) - 1)
    i = np.clip(x.astype(int), 0, len(stops) - 2)
    f = (x - i)[..., None]
    out = stops[i] * (1 - f) + stops[i + 1] * f
    _write(args.output, out.astype(np.float32))


def cmd_makeequiarea(args):
    import torch

    from ..core import rgb2spec
    from ..lights.envmap import EnvironmentMap
    from ..render import check_device

    device = check_device(args.device)
    src = _read(args.input)
    env = EnvironmentMap.from_latlong(src, out_res=args.resolution)
    env = env.to(device)
    # Write the resampled octahedral image (round trip through the fit).
    rgb_from_s, lam = rgb2spec._projection("srgb")
    # Direct reconstruction of the stored luminance-weighted image:
    spec = rgb2spec.eval_unbounded(env.coeffs, env.scale,
                                   torch.from_numpy(lam).to(device))
    img = spec.cpu().numpy() @ rgb_from_s.T
    _write(args.output, img.astype(np.float32))


def cmd_whitebalance(args):
    img = _read(args.input)
    m = colorspace.white_balance_matrix(
        (args.src_x, args.src_y), colorspace.SRGB.white_xy
    )
    xyz = np.asarray(colorspace.SRGB.xyz_from_rgb) @ img.reshape(-1, 3).T
    xyz = m @ xyz
    out = (np.asarray(colorspace.SRGB.rgb_from_xyz) @ xyz).T.reshape(img.shape)
    _write(args.output, out.astype(np.float32))


def cmd_bloom(args):
    img = _read(args.input)
    bright = np.where(img > args.threshold, img, 0.0)
    k = args.width
    x = np.arange(-3 * k, 3 * k + 1)
    g = np.exp(-0.5 * (x / k) ** 2)
    g /= g.sum()
    blurred = bright
    for axis in (0, 1):
        blurred = np.apply_along_axis(
            lambda r: np.convolve(r, g, mode="same"), axis, blurred
        )
    _write(args.output, (img + args.scale * blurred).astype(np.float32))


def cmd_cat(args):
    """Print pixel values (imgtool cat, cmd/imgtool.cpp)."""
    img = _read(args.input)
    h, w = img.shape[:2]
    if not args.csv:
        print(f"{args.input}: {w} x {h}, {img.shape[2]} channels")
    for y in range(h):
        for x in range(w):
            px = img[y, x]
            if args.csv:
                print(",".join(f"{v:.9g}" for v in px))
            else:
                print(f"({x}, {y}): " + " ".join(f"{v:.9g}" for v in px))
    return 0


def cmd_scalenormalmap(args):
    """Scale tangent-space normal-map strength (imgtool scalenormalmap):
    decode [0,1] -> [-1,1], scale xy by the factor, renormalize, re-encode.
    """
    img = _read(args.input).astype(np.float32)
    n = img * 2.0 - 1.0
    n[..., :2] *= args.scale
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    _write(args.output, ((n + 1.0) * 0.5).astype(np.float32))
    return 0


def cmd_makeemitters(args):
    """Emit pbrt scene text with one emissive quad per (downsampled) image
    pixel (imgtool makeemitters, cmd/imgtool.cpp)."""
    img = _read(args.input).astype(np.float32)
    ds = max(1, args.downsample)
    h, w = img.shape[:2]
    hh, ww = h // ds, w // ds
    img = img[: hh * ds, : ww * ds].reshape(hh, ds, ww, ds, -1).mean((1, 3))
    lines = []
    for y in range(hh):
        for x in range(ww):
            rgb = img[y, x][:3]
            if not np.any(rgb > 0):
                continue
            x0, x1 = x / ww, (x + 1) / ww
            # flip y so image-up is +y in scene space
            y0, y1 = 1.0 - (y + 1) / hh, 1.0 - y / hh
            lines.append("AttributeBegin")
            lines.append(
                '  AreaLightSource "diffuse" "rgb L" '
                f"[{rgb[0]:.6g} {rgb[1]:.6g} {rgb[2]:.6g}]"
            )
            lines.append(
                '  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
                '"point3 P" '
                f"[{x0:.6g} {y0:.6g} 0 {x1:.6g} {y0:.6g} 0 "
                f"{x1:.6g} {y1:.6g} 0 {x0:.6g} {y1:.6g} 0]"
            )
            lines.append("AttributeEnd")
    text = "\n".join(lines) + "\n"
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="imgtool")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--exposure", type=float, default=1.0)
    c.add_argument("--tonemap", action="store_true")
    c.set_defaults(fn=cmd_convert)

    c = sub.add_parser("diff")
    c.add_argument("image")
    c.add_argument("reference")
    c.add_argument("--outfile")
    c.add_argument("--metric-limit", type=float, default=None)
    c.add_argument("--flip", action="store_true",
                   help="also compute the FLIP perceptual metric")
    c.add_argument("--ppd", type=float, default=67.0)
    c.set_defaults(fn=cmd_diff)

    c = sub.add_parser("error")
    c.add_argument("inputs", nargs="+")
    c.add_argument("--reference", required=True)
    c.add_argument("--metric-limit", type=float, default=None)
    c.add_argument("--flip", action="store_true")
    c.add_argument("--ppd", type=float, default=67.0)
    c.set_defaults(fn=cmd_error)

    c = sub.add_parser("denoise")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--aov", default=None,
                   help="GBuffer EXR from pbrt_render --gbuffer")
    c.add_argument("--radius", type=int, default=5)
    c.set_defaults(fn=cmd_denoise)

    c = sub.add_parser("makesky")
    c.add_argument("output")
    c.add_argument("--resolution", type=int, default=128)
    c.add_argument("--elevation", type=float, default=30.0)
    c.add_argument("--azimuth", type=float, default=0.0)
    c.add_argument("--turbidity", type=float, default=3.0)
    c.add_argument("--sun-intensity", type=float, default=100.0)
    c.add_argument("--sun-half-angle", type=float, default=0.2665)
    c.add_argument("--model", choices=("hosek", "preetham"),
                   default="hosek")
    c.add_argument("--albedo", type=float, default=0.3)
    c.set_defaults(fn=cmd_makesky)

    c = sub.add_parser("average")
    c.add_argument("inputs", nargs="+")
    c.add_argument("--output", required=True)
    c.set_defaults(fn=cmd_average)

    c = sub.add_parser("assemble")
    c.add_argument("inputs", nargs="+")
    c.add_argument("--output", required=True)
    c.set_defaults(fn=cmd_assemble)

    c = sub.add_parser("falsecolor")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--min", type=float, default=0.0)
    c.add_argument("--max", type=float, default=None)
    c.set_defaults(fn=cmd_falsecolor)

    c = sub.add_parser("makeequiarea")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--resolution", type=int, default=256)
    c.add_argument("--device", default="cuda",
                   help="torch device of the fit's evaluation (default cuda)")
    c.set_defaults(fn=cmd_makeequiarea)

    c = sub.add_parser("whitebalance")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--src-x", type=float, default=0.3127)
    c.add_argument("--src-y", type=float, default=0.3290)
    c.set_defaults(fn=cmd_whitebalance)

    c = sub.add_parser("cat")
    c.add_argument("input")
    c.add_argument("--csv", action="store_true")
    c.set_defaults(fn=cmd_cat)

    c = sub.add_parser("scalenormalmap")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--scale", type=float, default=1.0)
    c.set_defaults(fn=cmd_scalenormalmap)

    c = sub.add_parser("makeemitters")
    c.add_argument("input")
    c.add_argument("--output", default=None)
    c.add_argument("--downsample", type=int, default=1)
    c.set_defaults(fn=cmd_makeemitters)

    c = sub.add_parser("bloom")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--threshold", type=float, default=1.0)
    c.add_argument("--width", type=int, default=8)
    c.add_argument("--scale", type=float, default=0.3)
    c.set_defaults(fn=cmd_bloom)

    args = p.parse_args(argv)
    # Expand globs for multi-input commands on platforms without shell glob.
    if hasattr(args, "inputs"):
        expanded = []
        for pat in args.inputs:
            expanded.extend(sorted(globmod.glob(pat)) or [pat])
        args.inputs = expanded
    rc = args.fn(args)
    return rc or 0


if __name__ == "__main__":
    sys.exit(main())
