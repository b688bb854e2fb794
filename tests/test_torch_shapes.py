"""The port's shape families against the JAX reference on the CPU: the
host builders (curve flattening, Loop subdivision), the parser's disk,
cylinder, bilinear mesh, Loop subdivision and curve shapes (analytic and
tessellated), GeometryBuffers bit-equal after convert.py, and the shapes
box (tests/data/torch_port/shapes.pbrt) against its JAX per-sample golden
(scripts/make_torch_port_golden_shapes.py).
"""

import numpy as np
import pytest
import torch

from pbrt_tpu.io.parser import load_pbrt as jax_load_pbrt
from pbrt_tpu.io.parser import load_pbrt_string as jax_load_pbrt_string
from pbrt_tpu.shapes import curve as jcurve
from pbrt_tpu.shapes.subdiv import loop_subdivide as jax_loop_subdivide
from pbrt_tpu_torch.accel import api
from pbrt_tpu_torch.convert import scene_from_arrays
from pbrt_tpu_torch.io.parser import load_pbrt, load_pbrt_string
from pbrt_tpu_torch.render import camera_rays_full
from pbrt_tpu_torch.shapes import curve
from pbrt_tpu_torch.shapes.subdiv import loop_subdivide

from .test_torch_parser import _assert_same_build
from .torch_port_helpers import flatten_jax, share_close
from .torch_port_shapes import DATA, SHAPES_PBRT, coarse_alpha_keys

torch.set_num_threads(2)


def _curves(rng):
    out = []
    for k in range(12):
        n = 4 if k % 3 else 7
        out.append({"cp": rng.normal(size=(n, 3)).astype(np.float32),
                    "basis": "bspline" if k % 4 == 0 else "bezier",
                    "width0": 0.05, "width1": 0.01 * (k + 1), "mat": k % 2})
    return out


def test_curve_segments_match_jax():
    rng = np.random.default_rng(0)
    curves = _curves(rng)
    for c in curves:
        assert curve.segment_count(c["cp"][:4]) == jcurve.segment_count(
            c["cp"][:4])
    for got, want in zip(curve.build_curve_segments(curves),
                         jcurve.build_curve_segments(curves)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(curve.build_curve_segments([]),
                         jcurve.build_curve_segments([])):
        assert got.shape == want.shape


@pytest.mark.parametrize("levels", [1, 2])
def test_loop_subdivision_matches_jax(levels):
    """A closed octahedron and an open fan (boundary and corner masks)."""
    octa = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                       [0, 0, 1], [0, 0, -1]], np.float64)
    faces = np.asarray([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                        [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    fan_v = np.asarray([[0, 0, 0], [1, 0, 0.2], [0, 1, -0.1], [-1, 0, 0.3],
                        [0, -1, 0]], np.float64)
    fan_f = np.asarray([[0, 1, 2], [0, 2, 3], [0, 3, 4]])
    for v, f in ((octa, faces), (fan_v, fan_f)):
        for got, want in zip(loop_subdivide(v, f, levels),
                             jax_loop_subdivide(v, f, levels)):
            np.testing.assert_array_equal(got, want)


_SHAPES = """
Material "diffuse"
AttributeBegin
  Translate 0.2 0.1 0.3 Rotate 30 1 1 0 Scale 1.5 1.5 1.5
  Shape "disk" "float radius" 0.5 "float innerradius" 0.1 "float height" 0.2
  Shape "cylinder" "float radius" 0.3 "float zmin" -0.2 "float zmax" 0.7
  Shape "bilinearmesh" "point3 P" [0 0 0 1 0 0 0 1 0 1 1 0.5
                                   2 0 0 2 1 0.3] "integer indices" [0 1 2 3 1 4 3 5]
  Shape "curve" "point3 P" [0 0 0 0.1 0.5 0 0.3 0.8 0.1 0.2 1.2 0] "float width" 0.05
  Shape "curve" "point3 P" [0 0 0 0.1 0.5 0 0.3 0.8 0.1 0.2 1.2 0 0.5 1.5 0]
    "string basis" "bspline" "float width0" 0.04 "float width1" 0.01
  Shape "loopsubdiv" "integer levels" 1
    "point3 P" [1 0 0 -1 0 0 0 1 0 0 -1 0 0 0 1 0 0 -1]
    "integer indices" [0 2 4 2 1 4 1 3 4 3 0 4 2 0 5 1 2 5 3 1 5 0 3 5]
AttributeEnd
AttributeBegin
  Scale 1 2 1
  Shape "disk" "float radius" 0.4
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [2 2 2]
  Shape "disk" "float radius" 0.3
  Shape "cylinder" "float radius" 0.1
  Shape "bilinearmesh" "point3 P" [0 3 0 1 3 0 0 3 1 1 3.2 1]
AttributeEnd
"""


def test_parser_shapes_match_jax():
    """Analytic disks, cylinders, patches and curves, Loop subdivision,
    an anisotropic disk (tessellated, with the reference's warning) and
    emissive disks, cylinders and patches (tessellated) build the
    reference's scene bit for bit."""
    built = load_pbrt_string(_SHAPES, device="cpu")
    _assert_same_build(jax_load_pbrt_string(_SHAPES), built)
    g = built[0].geom
    assert (g.num_disks, g.num_cyls, g.num_blps) == (1, 1, 2)
    assert g.num_curves > 0 and g.num_triangles > 64 + 128 + 32
    assert any("tessellated" in w for w in built[2]["warnings"])


def test_shapes_box_builds_and_converts():
    port = load_pbrt(SHAPES_PBRT, device="cpu")
    jax_built = jax_load_pbrt(SHAPES_PBRT)
    _assert_same_build(jax_built, port)
    scene = port[0]
    g = scene.geom
    assert scene.small is not None and g.num_triangles == 336
    assert g.has_alpha and (g.num_disks, g.num_cyls, g.num_blps) == (1, 1, 1)
    assert g.num_curves == jax_built[0].geom.num_curves == 126
    conv = scene_from_arrays(*flatten_jax(jax_built[0]))
    got, _ = flatten_jax(conv)
    for path, value in flatten_jax(scene)[0].items():
        np.testing.assert_array_equal(got[path], value, err_msg=path)


def _pass(scene, camera, integ, res, spp):
    npix = res * res
    pixel = torch.arange(npix).repeat(spp)
    sample = torch.arange(spp).repeat_interleave(npix)
    o, d, wl, _ = camera_rays_full(camera.replace(resolution=(res, res)),
                                   pixel, sample, 0, n_spectrum=8)
    with torch.no_grad(), coarse_alpha_keys(api):
        L, stats = integ.trace_with_stats(scene, o, d, wl, pixel, sample, 0)
    return L.numpy(), float(stats["rays"])


# The ray count the port's pass may differ from the reference's by: one
# lane of the 512 takes another path (ROADMAP Queue 3).
RAYS_SLACK = 2


@pytest.mark.parametrize("tier", ["small", "dense"])
def test_samples_match_jax(tier):
    """One pass at 16x16, 2 spp, depth 5 on coarse alpha keys against the
    reference's per-sample radiance: >= 99% of the values within rtol
    1e-3 / atol 1e-5 (all of them agree today), on K1's twin and on the
    dense tester (the reference's CPU tier)."""
    scene, camera, settings = load_pbrt(SHAPES_PBRT, device="cpu")
    if tier == "dense":
        scene = scene.replace(small=None)
    golden = np.load(f"{DATA}/shapes16_samples.npz")
    pL, p_rays = _pass(scene, camera, settings["integrator"],
                       int(golden["resolution"]), int(golden["spp"]))
    jL = golden["radiance"]
    assert pL.shape == jL.shape and np.isfinite(pL).all()
    share, n_bad = share_close(pL, jL, rtol=1e-3, atol=1e-5)
    print(f"rays {p_rays} / {float(golden['rays'])}; values off: {n_bad}")
    assert share >= 0.99, n_bad
    assert abs(p_rays - float(golden["rays"])) <= RAYS_SLACK
    assert jL.mean() > 0.1
