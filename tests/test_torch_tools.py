"""The port's tools (pbrt_tpu_torch/tools/: imgtool, format_scene,
plytool, lenstool, pspec, cyhair2pbrt, nanovdb2pbrt) against the JAX
package's on the same inputs, live on the CPU (none of them renders).

Each command runs twice, the reference's and the port's, on the same
inputs, writing into two directories: the exit codes and standard output
are equal, and so are the output files byte for byte, except where a
float is computed by another pipeline:
- makeequiarea's image: within rtol 1e-5 / atol 1e-6 on every texel
  whose nearest lat-long pixel both pipelines pick alike (the sigmoid
  spectra are evaluated by torch, not XLA); the equal-area directions
  differ in the last bit, which moves the pick of a texel whose centre
  maps exactly onto a pixel edge (ROADMAP Queue 3);
- an 8-bit sRGB code (PNG, QOI) from srgb_encode's power, which torch and
  XLA round differently in the last bit: each code within 1 (ROADMAP's
  list of loosened tolerances); every float output stays byte-equal;
- lenstool info's paraxial numbers and pspec's spectrum: rtol 1e-6.
The reference's own gates (tests/test_tools.py, test_format.py,
test_lens_ply_tools.py, test_cyhair.py, test_nanovdb.py) run on the
port's outputs too.
"""

import contextlib
import io
import json
import os
import struct

import numpy as np
import pytest
import torch

from pbrt_tpu.core import vecmath as jax_vecmath
from pbrt_tpu.io.nanovdb import NVDBGrid as JaxGrid
from pbrt_tpu.io.nanovdb import write_nanovdb
from pbrt_tpu.tools import cyhair2pbrt as jax_cyhair
from pbrt_tpu.tools import format_scene as jax_format
from pbrt_tpu.tools import imgtool as jax_imgtool
from pbrt_tpu.tools import lenstool as jax_lenstool
from pbrt_tpu.tools import nanovdb2pbrt as jax_nv
from pbrt_tpu.tools import plytool as jax_plytool
from pbrt_tpu.tools import pspec as jax_pspec
from pbrt_tpu_torch.io.image import read_exr, read_png, read_qoi, write_exr
from pbrt_tpu_torch.io.image import write_pfm
from pbrt_tpu_torch.io.parser import load_pbrt_string
from pbrt_tpu_torch.io.ply import read_ply, write_ply
from pbrt_tpu_torch.lights.envmap import equal_area_square_to_sphere
from pbrt_tpu_torch.tools import (cyhair2pbrt, format_scene, imgtool,
                                  lenstool, nanovdb2pbrt, plytool, pspec)

torch.set_num_threads(2)


def _run(fn, argv):
    """(return value, stdout) of a tool's main."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _both(tmp_path, jax_main, port_main, make_argv, port_extra=()):
    """Run the reference's and the port's main with make_argv(dir) in two
    directories; returns {name: (rc, stdout, {file: bytes})}."""
    out = {}
    for name, fn, extra in (("jax", jax_main, ()),
                            ("port", port_main, tuple(port_extra))):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        before = set(os.listdir(d))
        rc, stdout = _run(fn, [*make_argv(str(d)), *extra])
        files = {}
        for f in sorted(set(os.listdir(d)) - before):
            with open(d / f, "rb") as fh:
                files[f] = fh.read()
        out[name] = (rc, stdout.replace(str(d), "<dir>"), files)
    return out


def _img(seed=0, h=12, w=16):
    return np.random.default_rng(seed).uniform(0, 2, (h, w, 3)).astype(
        np.float32)


def _inputs(d):
    """Every input an imgtool case reads, written into d."""
    write_exr(os.path.join(d, "a.exr"), _img(0))
    write_exr(os.path.join(d, "b.exr"), _img(0) + 0.1)
    write_exr(os.path.join(d, "c.exr"), _img(1))
    write_pfm(os.path.join(d, "a.pfm"), _img(2, 2, 2) / 4.0)
    nm = np.random.default_rng(3).uniform(0, 1, (4, 4, 3)).astype(np.float32)
    write_pfm(os.path.join(d, "nm.pfm"), nm)
    aux = np.concatenate([_img(4)[..., :3] / 2, np.tile(
        [0.0, 0.0, 1.0], (12, 16, 1)).astype(np.float32),
        np.full((12, 16, 1), 3.0, np.float32)], -1)
    write_exr(os.path.join(d, "aux.exr"), aux,
              channel_names=["AlbedoR", "AlbedoG", "AlbedoB", "Nx", "Ny",
                             "Nz", "Depth"])
    for i, (x, y) in enumerate(((0, 0), (16, 0), (0, 12))):
        write_exr(os.path.join(d, f"tile{i}.exr"), _img(5 + i),
                  metadata={"tileX": str(x), "tileY": str(y)})
    for i in range(1, 4):
        write_exr(os.path.join(d, f"r{i}.exr"), _img(0) + 0.3 / i)
    write_exr(os.path.join(d, "latlong.exr"), _img(8, 8, 16))


IMGTOOL_CASES = {
    "convert_png": lambda d: ["convert", f"{d}/a.exr", f"{d}/o.png",
                              "--tonemap"],
    "convert_exposure_pfm": lambda d: ["convert", f"{d}/a.exr", f"{d}/o.pfm",
                                       "--exposure", "1.5"],
    "convert_qoi": lambda d: ["convert", f"{d}/a.exr", f"{d}/o.qoi"],
    "diff": lambda d: ["diff", f"{d}/a.exr", f"{d}/b.exr", "--outfile",
                       f"{d}/o.exr", "--flip"],
    "diff_limit": lambda d: ["diff", f"{d}/a.exr", f"{d}/b.exr",
                             "--metric-limit", "0.001"],
    "error": lambda d: ["error", f"{d}/r1.exr", f"{d}/r2.exr", f"{d}/r3.exr",
                        "--reference", f"{d}/a.exr", "--flip"],
    "error_limit": lambda d: ["error", f"{d}/r3.exr", "--reference",
                              f"{d}/a.exr", "--metric-limit", "1e-6"],
    "denoise": lambda d: ["denoise", f"{d}/a.exr", f"{d}/o.exr", "--aov",
                          f"{d}/aux.exr", "--radius", "2"],
    "makesky_hosek": lambda d: ["makesky", f"{d}/o.exr", "--resolution", "8",
                                "--elevation", "25"],
    "makesky_preetham": lambda d: ["makesky", f"{d}/o.exr", "--resolution",
                                   "8", "--model", "preetham"],
    "average": lambda d: ["average", f"{d}/a.exr", f"{d}/c.exr",
                          "--output", f"{d}/o.exr"],
    "average_glob": lambda d: ["average", f"{d}/r*.exr", "--output",
                               f"{d}/o.pfm"],
    "assemble": lambda d: ["assemble", f"{d}/tile0.exr", f"{d}/tile1.exr",
                           f"{d}/tile2.exr", "--output", f"{d}/o.exr"],
    "falsecolor": lambda d: ["falsecolor", f"{d}/a.exr", f"{d}/o.png"],
    "falsecolor_range": lambda d: ["falsecolor", f"{d}/a.exr", f"{d}/o.exr",
                                   "--min", "0.2", "--max", "1.5"],
    "whitebalance": lambda d: ["whitebalance", f"{d}/a.exr", f"{d}/o.exr",
                               "--src-x", "0.35", "--src-y", "0.36"],
    "cat": lambda d: ["cat", f"{d}/a.pfm"],
    "cat_csv": lambda d: ["cat", f"{d}/a.pfm", "--csv"],
    "scalenormalmap": lambda d: ["scalenormalmap", f"{d}/nm.pfm",
                                 f"{d}/o.pfm", "--scale", "0.5"],
    "makeemitters": lambda d: ["makeemitters", f"{d}/a.pfm", "--output",
                               f"{d}/o.pbrt"],
    "makeemitters_stdout": lambda d: ["makeemitters", f"{d}/c.exr",
                                      "--downsample", "4"],
    "bloom": lambda d: ["bloom", f"{d}/a.exr", f"{d}/o.exr", "--threshold",
                        "1.5", "--width", "1"],
}


@pytest.mark.parametrize("case", sorted(IMGTOOL_CASES))
def test_imgtool_subcommand_matches_reference(tmp_path, case):
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        _inputs(str(tmp_path / name))
    res = _both(tmp_path, jax_imgtool.main, imgtool.main,
                IMGTOOL_CASES[case])
    (rc_j, out_j, files_j), (rc_p, out_p, files_p) = res["jax"], res["port"]
    assert rc_p == rc_j
    assert out_p == out_j
    assert sorted(files_p) == sorted(files_j)
    for f in files_j:
        if f.endswith((".png", ".qoi")) and files_p[f] != files_j[f]:
            reader = read_png if f.endswith(".png") else read_qoi
            a = reader(str(tmp_path / "port" / f))
            b = reader(str(tmp_path / "jax" / f))
            assert a.shape == b.shape
            assert np.abs(a.astype(np.float64) * 255
                          - b.astype(np.float64) * 255).max() <= 1.0 + 1e-6
        else:
            assert files_p[f] == files_j[f], f


def test_imgtool_diff_exit_codes(tmp_path):
    d = str(tmp_path)
    _inputs(d)
    assert imgtool.main(["diff", f"{d}/a.exr", f"{d}/b.exr"]) == 0
    assert imgtool.main(["diff", f"{d}/a.exr", f"{d}/b.exr",
                         "--metric-limit", "0.001"]) == 1
    with pytest.raises(ValueError, match="unsupported"):
        imgtool.main(["convert", f"{d}/a.exr", f"{d}/o.tga"])


def test_imgtool_makeequiarea_matches_reference(tmp_path):
    res = _both(tmp_path, jax_imgtool.main, imgtool.main,
                lambda d: (_inputs(d), ["makeequiarea", f"{d}/latlong.exr",
                                        f"{d}/o.exr", "--resolution",
                                        "8"])[1],
                port_extra=("--device", "cpu"))
    assert res["port"][0] == res["jax"][0] == 0
    got, _, _ = read_exr(str(tmp_path / "port" / "o.exr"))
    want, _, _ = read_exr(str(tmp_path / "jax" / "o.exr"))
    assert got.shape == (8, 8, 3)
    # Each texel's nearest lat-long pixel, picked from either pipeline's
    # equal-area directions: they differ in the last bit, and where a
    # texel centre maps exactly onto a pixel edge the picks differ.
    u = (np.arange(8) + 0.5) / 8
    uu, vv = np.meshgrid(u, u, indexing="xy")
    p = np.stack([uu, vv], axis=-1).reshape(-1, 2).astype(np.float32)
    picks = []
    for d in (np.asarray(jax_vecmath.equal_area_square_to_sphere(p)),
              equal_area_square_to_sphere(torch.from_numpy(p)).numpy()):
        theta = np.arccos(np.clip(d[:, 2], -1, 1))
        phi = np.arctan2(d[:, 1], d[:, 0]) % (2 * np.pi)
        picks.append((phi / (2 * np.pi) * 16).astype(int) * 8
                     + (theta / np.pi * 8).astype(int))
    same = (picks[0] == picks[1]).reshape(8, 8)
    assert same.mean() >= 0.8, same.mean()
    np.testing.assert_allclose(got[same], want[same], rtol=1e-5, atol=1e-6)


def test_imgtool_makeequiarea_cuda_without_card_raises(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path)
    _inputs(d)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imgtool.main(["makeequiarea", f"{d}/latlong.exr", f"{d}/o.exr"])


# --- format_scene (tests/test_format.py's scenes) ---------------------------

_SCENE = """
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [32] "integer yresolution" [32]
Sampler "halton" "integer pixelsamples" [8]
Integrator "path" "integer maxdepth" [4]
WorldBegin
LightSource "point" "point3 from" [0 5 0] "rgb I" [10 10 10]
AttributeBegin
  Translate 0 0 3
  Rotate 45 0 1 0
  Material "conductor" "float roughness" [0.1]
  Shape "trianglemesh"
    "point3 P" [ -1 -1 0  1 -1 0  1 1 0  -1 1 0 ]
    "integer indices" [ 0 1 2  0 2 3 ]
AttributeEnd
"""

_V3 = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
  "float scale" [2]
Sampler "lowdiscrepancy" "integer pixelsamples" [4]
Integrator "directlighting" "float rrthreshold" [0.5]
PixelFilter "gaussian" "float xwidth" [2] "float alpha" [2]
Camera "environment"
WorldBegin
Texture "t" "spectrum" "imagemap" "string mapname" "x.png"
Material "matte" "rgb Kd" [0.6 0.5 0.4] "float sigma" [10]
Shape "sphere" "float radius" [1]
Material "glass" "float index" [1.7]
Shape "sphere" "float radius" [0.5]
Material "mirror"
Shape "sphere" "float radius" [0.2]
Material "uber" "rgb Ks" [0 0 0] "rgb Kd" [0.2 0.2 0.2]
MakeNamedMaterial "m" "string type" "plastic" "rgb Kd" [0.1 0.2 0.3]
Material "mix" "rgb amount" [0.2 0.4 0.6] "string namedmaterial1" "a"
  "string namedmaterial2" "b"
Material "translucent" "rgb Kd" [0.5 0.5 0.5]
Material "metal"
Material "substrate"
Material "kdsubsurface"
Material "fourier"
MakeNamedMedium "smoke" "string type" "heterogeneous"
Shape "loopsubdiv" "integer nlevels" [2]
  "point3 P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
"""


def _format(mod, text, **kw):
    buf = io.StringIO()
    warnings = mod.SceneFormatter(out=buf, **kw).format_string(text)
    return buf.getvalue(), warnings


@pytest.mark.parametrize("scene,kw", [(_SCENE, {}), (_V3, {}),
                                      (_V3, {"upgrade": True})],
                         ids=["format", "v3_format", "v3_upgrade"])
def test_format_scene_matches_reference(scene, kw):
    got = _format(format_scene, scene, **kw)
    assert got == _format(jax_format, scene, **kw)
    # tests/test_format.py's gates: idempotent, and the output parses.
    if not kw:
        assert _format(format_scene, got[0])[0] == got[0]
    if scene is _SCENE:
        sc_a, _, set_a = load_pbrt_string(_SCENE, device="cpu")
        sc_b, _, set_b = load_pbrt_string(got[0], device="cpu")
        np.testing.assert_allclose(sc_a.geom.tri_verts.numpy(),
                                   sc_b.geom.tri_verts.numpy(), atol=1e-4)
        assert set_a["spp"] == set_b["spp"]


def test_format_scene_toply_and_main_match_reference(tmp_path):
    rng = np.random.default_rng(0)
    n = 300
    pts = rng.uniform(-1, 1, (n * 3, 3))
    big = ("WorldBegin\n" + 'Shape "trianglemesh" "point3 P" ['
           + " ".join(f"{v:.5f}" for v in pts.reshape(-1))
           + '] "integer indices" ['
           + " ".join(str(i) for i in range(n * 3)) + "]\n")

    def argv(d):
        with open(os.path.join(d, "big.pbrt"), "w") as f:
            f.write(big)
        return [os.path.join(d, "big.pbrt"), "--toply"]

    res = _both(tmp_path, jax_format.main, format_scene.main, argv)
    assert res["port"] == res["jax"]
    assert 'Shape "plymesh"' in res["port"][1]
    verts, faces = read_ply(str(tmp_path / "port" / "mesh_00001.ply"))
    assert faces.shape == (n, 3)
    np.testing.assert_allclose(verts, pts, atol=1e-4)


# --- plytool, lenstool, pspec -----------------------------------------------

def _mesh(d, nx=4):
    xs, ys = np.meshgrid(np.arange(nx), np.arange(nx))
    verts = np.stack([xs.ravel(), ys.ravel(), 0.1 * (xs * ys).ravel()],
                     -1).astype(np.float32)
    faces = []
    for y in range(nx - 1):
        for x in range(nx - 1):
            a = y * nx + x
            faces += [[a, a + 1, a + nx], [a + 1, a + nx + 1, a + nx]]
    write_ply(os.path.join(d, "m.ply"), verts, np.asarray(faces, np.int32))
    write_exr(os.path.join(d, "disp.exr"), _img(9, 8, 8))
    return os.path.join(d, "m.ply")


PLYTOOL_CASES = {
    "info": lambda d: ["info", _mesh(d)],
    "cat": lambda d: ["cat", _mesh(d)],
    "split": lambda d: ["split", _mesh(d), "--maxfaces", "7"],
    "displace": lambda d: ["displace", _mesh(d), f"{d}/out.ply", "--image",
                           f"{d}/disp.exr", "--scale", "0.5", "--uvscale",
                           "2"],
}


@pytest.mark.parametrize("case", sorted(PLYTOOL_CASES))
def test_plytool_matches_reference(tmp_path, case):
    res = _both(tmp_path, jax_plytool.main, plytool.main,
                PLYTOOL_CASES[case])
    assert res["port"] == res["jax"]
    if case == "split":
        assert len(res["port"][2]) == 2 + (18 + 6) // 7  # inputs + chunks


_DAT = """# test biconvex
# a two-surface singlet
50.0 2.0 1.5 25.0
-50.0 48.0 1.0 25.0
"""
_MICRO = {"name": "ml", "description": "", "surfaces": [
    {"radius": 0.5, "thickness": 0.1, "semi_aperture": 0.05, "ior": 1.5},
    {"radius": 0.0, "thickness": 0.0, "semi_aperture": 0.05, "ior": 1.0}]}


def _lens_inputs(d):
    with open(os.path.join(d, "lens.dat"), "w") as f:
        f.write(_DAT)
    with open(os.path.join(d, "micro.json"), "w") as f:
        json.dump(_MICRO, f)
    return d


LENSTOOL_CASES = {
    "convert": lambda d: ["convert", f"{_lens_inputs(d)}/lens.dat",
                          f"{d}/lens.json"],
    "convert_implicit": lambda d: ["convert", f"{_lens_inputs(d)}/lens.dat",
                                   f"{d}/lens.json", "--inputscale", "2",
                                   "--implicitdefaults"],
}


@pytest.mark.parametrize("case", sorted(LENSTOOL_CASES))
def test_lenstool_matches_reference(tmp_path, case):
    res = _both(tmp_path, jax_lenstool.main, lenstool.main,
                LENSTOOL_CASES[case])
    assert res["port"] == res["jax"]


def test_lenstool_insertmicrolens_matches_reference(tmp_path):
    def argv(d):
        _lens_inputs(d)
        _run(jax_lenstool.main, ["convert", f"{d}/lens.dat",
                                 f"{d}/main.json"])
        return ["insertmicrolens", f"{d}/main.json", f"{d}/micro.json",
                f"{d}/out.json", "--xdim", "4", "--ydim", "4"]

    res = _both(tmp_path, jax_lenstool.main, lenstool.main, argv)
    assert res["port"] == res["jax"]
    from pbrt_tpu_torch.cameras.realistic import load_lens_json

    stack, micro = load_lens_json(str(tmp_path / "port" / "out.json"))
    assert micro is not None and stack.n_surfaces == 2


def _numbers(text):
    out = []
    for tok in text.replace("[", " ").replace("]", " ").split():
        try:
            out.append(float(tok))
        except ValueError:
            pass
    return np.asarray(out)


@pytest.mark.parametrize("lens", ["lens.dat", "lens.json"])
def test_lenstool_info_matches_reference(tmp_path, lens):
    def argv(d):
        _lens_inputs(d)
        _run(jax_lenstool.main, ["convert", f"{d}/lens.dat",
                                 f"{d}/lens.json"])
        return ["info", f"{d}/{lens}"]

    res = _both(tmp_path, jax_lenstool.main, lenstool.main, argv,
                port_extra=("--device", "cpu"))
    got, want = res["port"][1], res["jax"][1]
    assert "focal length" in got
    assert got.split("paraxial")[0] == want.split("paraxial")[0]
    np.testing.assert_allclose(_numbers(got), _numbers(want), rtol=1e-6)
    # The lensmaker's f = R / (2 (n - 1)) = 50 for this biconvex singlet.
    f = float(got.split("focal length ~")[1].split("mm")[0])
    assert 40.0 < f < 60.0


@pytest.mark.parametrize("kind", ["independent", "stratified", "sobol",
                                  "halton"])
def test_pspec_matches_reference(kind):
    got = pspec.power_spectrum(kind, spp=64, n_sets=3, res=16, dim=0,
                               device="cpu")
    want = jax_pspec.power_spectrum(kind, spp=64, n_sets=3, res=16, dim=0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_pspec_main_and_low_discrepancy(tmp_path):
    out = str(tmp_path / "ps.png")
    rc, stdout = _run(pspec.main, ["--sampler", "sobol", "--spp", "64",
                                   "--nsets", "2", "--res", "32", "--out",
                                   out, "--device", "cpu"])
    assert rc == 0 and "low/high frequency power ratio" in stdout
    assert read_png(out).shape == (32, 32, 3)
    # tests/test_tools.py's gate: Sobol' suppresses low frequencies.
    res = 32
    ps_ind = pspec.power_spectrum("independent", 64, 6, res, dim=0,
                                  device="cpu")
    ps_sob = pspec.power_spectrum("sobol", 64, 6, res, dim=0, device="cpu")
    yy, xx = np.mgrid[0:res, 0:res]
    rad = np.hypot(yy - res // 2, xx - res // 2)
    low = (rad > 0) & (rad < res * 0.08)
    assert ps_sob[low].mean() < 0.35 * ps_ind[low].mean()


# --- cyhair2pbrt, nanovdb2pbrt ---------------------------------------------

def _write_hair(path, strands, thickness=None, default_thickness=0.02):
    pts = np.concatenate(strands, 0).astype("<f4")
    segs = np.asarray([s.shape[0] - 1 for s in strands], "<u2")
    flags = 0x1 | 0x2
    blobs = [segs.tobytes(), pts.tobytes()]
    if thickness is not None:
        flags |= 0x4
        blobs.append(np.asarray(thickness, "<f4").tobytes())
    header = struct.pack("<4sIIIIff3f88s", b"HAIR", len(strands),
                         pts.shape[0], flags, 0, default_thickness, 1.0, 0.5,
                         0.3, 0.2, b"")
    with open(path, "wb") as f:
        f.write(header)
        for b in blobs:
            f.write(b)


@pytest.mark.parametrize("args", [[], ["2"], ["-1", "0.01"]],
                         ids=["all", "maxstrands", "thickness"])
def test_cyhair2pbrt_matches_reference(tmp_path, args):
    rng = np.random.default_rng(1)
    strands = [np.cumsum(rng.normal(scale=0.1, size=(n, 3)), 0)
               for n in (6, 4, 5)]

    def argv(d):
        _write_hair(os.path.join(d, "h.hair"), strands,
                    thickness=rng.uniform(0.01, 0.05, 15))
        return [os.path.join(d, "h.hair"), os.path.join(d, "h.pbrt"), *args]

    rng_state = rng.bit_generator.state
    res = {}
    for name, mod in (("jax", jax_cyhair), ("port", cyhair2pbrt)):
        rng.bit_generator.state = rng_state
        d = tmp_path / name
        d.mkdir()
        assert mod.main(argv(str(d))) == 0
        res[name] = (d / "h.pbrt").read_text().replace(str(d), "<dir>")
    assert res["port"] == res["jax"]
    # tests/test_cyhair.py's gates on the port's own functions.
    ss, tt = cyhair2pbrt.read_cyhair(str(tmp_path / "port" / "h.hair"))
    np.testing.assert_allclose(ss[0], strands[0], rtol=1e-6)
    bez = cyhair2pbrt.catmullrom_to_beziers(np.asarray(strands[0]))
    np.testing.assert_array_equal(
        bez, jax_cyhair.catmullrom_to_beziers(np.asarray(strands[0])))
    text = io.StringIO()
    n = cyhair2pbrt.convert(str(tmp_path / "port" / "h.hair"), text,
                            thickness=0.01)
    assert n == 5 + 3 + 4 and text.getvalue().count('Shape "curve"') == n
    scene, _, _ = load_pbrt_string(
        'Film "rgb" "integer xresolution" 8 "integer yresolution" 8\n'
        'Camera "perspective"\nWorldBegin\nMaterial "hair"\n'
        + text.getvalue(), device="cpu")
    assert scene.geom.num_curves > 0


@pytest.mark.parametrize("downsample", [0, 1])
def test_nanovdb2pbrt_matches_reference(tmp_path, downsample):
    rng = np.random.default_rng(4)
    g = JaxGrid(name="density",
                values=rng.uniform(0, 1, (5, 6, 8)).astype(np.float32),
                ijk_min=np.asarray([2, -1, 0], np.int32),
                voxel_size=np.asarray([0.5, 0.5, 0.5]))
    path = str(tmp_path / "g.nvdb")
    write_nanovdb(path, g, codec="zip")
    argv = [path, "--downsample", str(downsample), "--grid", "density"]
    got = _run(nanovdb2pbrt.main, argv)
    assert got == _run(jax_nv.main, argv)
    assert got[0] == 0 and '"float density" [' in got[1]
    missing = [str(tmp_path / "missing.nvdb")]
    assert nanovdb2pbrt.main(missing) == 1 == jax_nv.main(missing)
