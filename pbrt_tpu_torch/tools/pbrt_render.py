"""Main renderer CLI (the `pbrt` executable equivalent).

Port of pbrt_tpu/tools/pbrt_render.py, with every flag of it plus
--device (default cuda: the card; a missing card raises, nothing falls
back to the CPU). Reference analogue: pbrt-v4 src/pbrt/cmd/pbrt.cpp.
Usage:

    python -m pbrt_tpu_torch.tools.pbrt_render scene.pbrt --outfile out.exr \
        [--spp N] [--seed S] [--maxdepth D] [--device cuda|cpu] \
        [--display-server host:port]

The parse puts the scene on the device with its triangle tier attached
(K1 up to 1,024 triangles, K2 above), and every query of the render runs
there. The function integrator prints its exact integral and MSE; MLT,
SPPM, BDPT and the light path own their render loops, the rest go through
the sample-wave renderer (render.render_file).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# The GBuffer EXR's channels, in the order of the reference's.
AOV_CHANNELS = ("Px", "Py", "Pz", "Nx", "Ny", "Nz", "AlbedoR", "AlbedoG",
                "AlbedoB", "Depth", "MaterialId", "PrimId", "Variance")


def _parser():
    p = argparse.ArgumentParser(prog="pbrt_tpu_torch")
    p.add_argument("scene")
    p.add_argument("--outfile", default="out.exr")
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--maxdepth", type=int, default=None)
    p.add_argument("--samples-per-pass", type=int, default=4)
    p.add_argument("--disable-pixel-jitter", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--stats", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the render (default cuda; a "
                        "missing card raises)")
    p.add_argument("--interactive", action="store_true",
                   help="serve a live viewer with keyboard camera controls "
                        "(the reference's GUI, as a built-in HTTP viewer)")
    p.add_argument("--gui-port", type=int, default=8788)
    p.add_argument("--display-server", default=None,
                   help="tev host:port for live preview")
    p.add_argument("--mse-reference-image", default=None,
                   help="compute MSE vs this converged EXR (the reference's "
                        "--mse-reference-image convergence harness)")
    p.add_argument("--mse-out", default=None,
                   help="append the MSE record as a JSON line to this file")
    p.add_argument("--gbuffer", action="store_true",
                   help="also write <outfile>_aov.exr with GBuffer channels")
    p.add_argument("--spectral-buckets", type=int, default=0,
                   help="also write <outfile>_spectral.exr with N buckets")
    p.add_argument("--debugstart", default=None, metavar="X,Y,SAMPLE",
                   help="replay a single pixel sample deterministically and "
                        "print its radiance record (the reference's "
                        "--debugstart, cpu/integrators.cpp:69-88; the "
                        "stateless RNG makes the replay exact)")
    p.add_argument("--format", action="store_true", dest="format_scene",
                   help="print a reformatted version of the scene to "
                        "stdout and exit (pbrt --format)")
    p.add_argument("--toply", action="store_true",
                   help="like --format, but write large triangle meshes "
                        "to PLY files (pbrt --toply)")
    p.add_argument("--upgrade", action="store_true",
                   help="upgrade a pbrt-v3 scene to the v4 format while "
                        "reformatting (pbrt --upgrade)")
    return p


def debug_record(scene, camera, integrator, px: int, py: int, sidx: int,
                 seed: int, device) -> dict:
    """The --debugstart record of pixel (px, py)'s sample sidx: its camera
    ray, wavelengths, radiance, RGB and live query count."""
    import torch

    from ..films.rgb import spectrum_to_rgb
    from ..render import camera_rays

    nx, _ = camera.resolution
    pid = torch.tensor([py * nx + px], dtype=torch.int64, device=device)
    samp = torch.tensor([sidx], dtype=torch.int64, device=device)
    # The parsed scene carries its triangle tier already (load_pbrt).
    o, d, wl = camera_rays(camera, pid, samp, seed)
    L, stats = integrator.trace_with_stats(scene, o, d, wl, pid, samp, seed)
    rgb = spectrum_to_rgb(L, wl)
    return {
        "pixel": [px, py],
        "sample": sidx,
        "seed": seed,
        "ray_o": o[0].tolist(),
        "ray_d": d[0].tolist(),
        "lambdas": wl.lam[0].tolist(),
        "L": L[0].tolist(),
        "rgb": rgb[0].tolist(),
        "rays": float(stats["rays"]),
    }


def render_image(scene, camera, integrator, settings, spp: int, args,
                 device):
    """The CLI's dispatch (the reference's, cpu/render.cpp RenderCPU): the
    function integrator prints its exact integral and MSE; BDPT runs its
    own loop with the reference CLI's arguments; every other integrator
    goes through render.render_file. Returns the (ny, nx, 3) host image."""
    from ..models.bdpt import BDPTIntegrator, render_bdpt
    from ..models.function import FunctionIntegrator
    from ..render import render_file

    if isinstance(integrator, FunctionIntegrator):
        est, exact = integrator.render(
            camera.resolution, spp=spp, sampler_kind=settings["sampler"],
            seed=args.seed, device=device,
        )
        est = est.cpu().numpy()
        print(f"function={integrator.func} exact={exact:.6g} "
              f"mse={float(np.mean((est - exact) ** 2)):.3e}")
        return np.repeat(est[..., None], 3, axis=-1)
    if isinstance(integrator, BDPTIntegrator):
        img = render_bdpt(scene, camera, spp=spp,
                          max_depth=integrator.max_depth, seed=args.seed,
                          device=device)
    else:
        img = render_file(
            scene, camera, {**settings, "integrator": integrator}, spp=spp,
            seed=args.seed, samples_per_pass=args.samples_per_pass,
            jitter=not args.disable_pixel_jitter, device=device,
        )
    return img.cpu().numpy()


def write_aovs(scene, camera, integrator, spp: int, args, device) -> None:
    """--gbuffer / --spectral-buckets: <outfile>_aov.exr and
    <outfile>_spectral.exr from films/gbuffer.py::render_aovs."""
    from ..films.gbuffer import render_aovs
    from ..io.image import write_exr

    aovs = render_aovs(
        scene, camera, integrator, spp=min(spp, 8), seed=args.seed,
        spectral_buckets=args.spectral_buckets, device=device,
    )
    aovs = {k: v.cpu().numpy() for k, v in aovs.items()}
    base = args.outfile.rsplit(".", 1)[0]
    if args.gbuffer:
        chans = np.concatenate(
            [aovs["p"], aovs["n"], aovs["albedo_rgb"],
             aovs["depth"][..., None], aovs["material_id"][..., None],
             aovs["prim_id"][..., None], aovs["variance"][..., None]],
            axis=-1,
        )
        write_exr(base + "_aov.exr", chans, channel_names=list(AOV_CHANNELS))
    if args.spectral_buckets:
        write_exr(
            base + "_spectral.exr", aovs["spectral"],
            channel_names=[
                f"L{int(i):02d}" for i in range(args.spectral_buckets)
            ],
        )


def main(argv=None):
    args = _parser().parse_args(argv)

    if args.format_scene or args.toply or args.upgrade:
        from .format_scene import format_file

        format_file(args.scene, to_ply=args.toply, upgrade=args.upgrade)
        return

    from ..io.image import write_exr
    from ..io.parser import load_pbrt
    from ..render import check_device

    device = check_device(args.device)
    t0 = time.perf_counter()
    scene, camera, settings = load_pbrt(args.scene, device=device)
    if not args.quiet:
        for w in settings["warnings"]:
            print(f"warning: {w}", file=sys.stderr)
        print(
            f"parsed {args.scene}: {scene.geom.num_triangles} tris, "
            f"{scene.geom.num_spheres} spheres, "
            f"{scene.lights.n_lights} lights "
            f"({time.perf_counter() - t0:.2f}s)",
            file=sys.stderr,
        )

    integrator = settings["integrator"]
    if args.maxdepth is not None:
        if hasattr(integrator, "base"):  # MLT wraps a base integrator
            integrator = integrator.replace(
                base=integrator.base.replace(max_depth=args.maxdepth)
            )
        elif hasattr(integrator, "max_depth"):
            integrator = integrator.replace(max_depth=args.maxdepth)
    spp = args.spp or settings["spp"]
    spp = max(args.samples_per_pass, spp - spp % args.samples_per_pass)

    if args.debugstart:
        parts = args.debugstart.split(",")
        rec = debug_record(
            scene, camera, integrator, int(parts[0]), int(parts[1]),
            int(parts[2]) if len(parts) > 2 else 0, args.seed, device,
        )
        print(json.dumps(rec))
        return 0

    if args.interactive:
        from ..utils.gui import GUI, interactive_render_loop

        gui = GUI(args.scene, camera.resolution, port=args.gui_port)
        print(f"interactive viewer: {gui.url}", file=sys.stderr)
        try:
            img = interactive_render_loop(
                scene, camera, integrator, gui,
                samples_per_pass=args.samples_per_pass, seed=args.seed,
                device=device,
            )
        finally:
            gui.close()
        if img is not None:
            write_exr(args.outfile, img)
        return

    t0 = time.perf_counter()
    img = render_image(scene, camera, integrator, settings, spp, args, device)
    dt = time.perf_counter() - t0

    if args.display_server:
        from ..utils.display import send_to_tev

        host, _, port = args.display_server.partition(":")
        send_to_tev(img, name=args.outfile, host=host, port=int(port or 14158))

    meta = {
        "samplesPerPixel": str(spp),
        "renderTimeSeconds": f"{dt:.3f}",
        "generator": "pbrt_tpu_torch",
    }
    if args.outfile.endswith(".exr"):
        write_exr(args.outfile, img, metadata=meta)
    else:
        from .imgtool import _write

        _write(args.outfile, img)
    if not args.quiet:
        print(f"rendered {spp} spp in {dt:.2f}s -> {args.outfile}",
              file=sys.stderr)
    if args.gbuffer or args.spectral_buckets:
        write_aovs(scene, camera, integrator, spp, args, device)
    if args.mse_reference_image:
        from ..io.image import read_exr

        ref_img, chans, _ = read_exr(args.mse_reference_image)
        ref = np.stack(
            [ref_img[..., chans.index(c)] for c in "RGB"], axis=-1
        )
        mse = float(np.mean((img - ref) ** 2))
        rec = {"spp": spp, "seconds": dt, "mse": mse}
        print(json.dumps(rec))
        if args.mse_out:
            with open(args.mse_out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    if args.stats:
        print(json.dumps({"spp": spp, "seconds": dt,
                          "mean": float(img.mean())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
