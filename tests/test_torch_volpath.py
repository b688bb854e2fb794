"""The port's volumetric path integrator (pbrt_tpu_torch/models/volpath.py)
and its scene-file media against the reference on the CPU.

- Per sample against the reference's jitted trace (committed goldens of
  scripts/make_torch_port_golden_media.py, 16x16, 2 spp, 8 lanes): the
  cloud (bench's cloud_fwd scene: grid medium, DDA, depth 6, Russian
  roulette from 3) with the medium entry inset in both packages
  (tests/torch_port_media.py), and tests/goldens/fog.pbrt (a homogeneous
  interior medium behind a material-less sphere; four-crossing shadow
  rays). Gate: the same ray count, >= 99% of sample values within rtol
  1e-3 / atol 1e-5 and the mean within rtol 1e-3 (both read 100%). With
  the exact entry the cloud is printed and held to be finite and within
  10% in mean: its re-drawn lanes (5% of samples) each carry a whole
  walk's variance.
- The sigma_a gradient of tests/test_gradients.py's fog box
  (differentiable=True, 8x8, 48 spp) within 1e-3 relative of the JAX
  golden, and that file's finite-difference gate (the sign, agreement
  within 0.35).
- The parser's media: every MakeNamedMedium kind and MediumInterface
  build the reference's scene table for table; Material "" / "none" /
  "interface"; the path -> volpath upgrade; PathIntegrator refuses media.
- tests/test_medium_interface.py's gates on the port alone (the centre
  pixel's samples only, the estimator the reference's render gives that
  pixel).
"""

import os

import numpy as np
import pytest
import torch

from pbrt_tpu.io.parser import load_pbrt_string as jax_load_pbrt_string
from pbrt_tpu_torch.films.rgb import spectrum_to_rgb
from pbrt_tpu_torch.io.parser import load_pbrt, load_pbrt_string
from pbrt_tpu_torch.materials.buffers import MAT_INTERFACE
from pbrt_tpu_torch.media.medium import MED_VACUUM, MediumBuffers
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.models.volpath import VolPathIntegrator
from pbrt_tpu_torch.render import camera_rays, camera_rays_full
from pbrt_tpu_torch.scenes.cloud import cloud_scene, fog_box_scene

from .torch_port_helpers import flatten_jax, share_close
from .torch_port_media import inset_entry

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_port")
FOG = os.path.join(ROOT, "tests", "goldens", "fog.pbrt")


def _golden_pass(name):
    """(golden, port radiance, port rays, scene, camera, integrator,
    pixel, sample) of a per-sample golden's pass."""
    z = np.load(os.path.join(DATA, f"{name}16_samples.npz"))
    res, spp, lanes = int(z["resolution"]), int(z["spp"]), int(z["n_spectrum"])
    if name == "cloud":
        scene, camera = cloud_scene(resolution=(res, res))
        integ = VolPathIntegrator(max_depth=int(z["max_depth"]))
    else:
        scene, camera, settings = load_pbrt(FOG, device="cpu")
        camera = camera.replace(resolution=(res, res))
        integ = settings["integrator"]
        assert integ.max_depth == int(z["max_depth"])
    npix = res * res
    pixel = torch.arange(npix).repeat(spp)
    sample = torch.arange(spp).repeat_interleave(npix)
    o, d, wl, _ = camera_rays_full(camera, pixel, sample, int(z["seed"]),
                                   n_spectrum=lanes)
    args = (scene, o, d, wl, pixel, sample, int(z["seed"]))
    with inset_entry(MediumBuffers):
        L, stats = integ.trace_with_stats(*args)
    return z, L.numpy(), float(stats["rays"]), integ, args


@pytest.mark.parametrize("name", ["cloud", "fog"])
def test_render_per_sample_matches_reference(name):
    z, pL, p_rays, integ, args = _golden_pass(name)
    jL = z["radiance"]
    assert pL.shape == jL.shape and np.isfinite(pL).all()
    assert p_rays == float(z["rays"])
    share, n_bad = share_close(pL, jL, rtol=1e-3, atol=1e-5)
    print(f"{name}: {n_bad} of {jL.size} sample values disagree")
    assert share >= 0.99
    assert abs(pL.mean() - jL.mean()) <= 1e-3 * jL.mean() and jL.mean() > 0.05
    if name == "cloud":
        exact = integ.trace(*args).numpy()
        e_share = share_close(exact, jL, rtol=1e-3, atol=1e-5)[0]
        print(f"cloud, exact entry: share {e_share:.4f}, mean "
              f"{exact.mean():.6f} against {jL.mean():.6f}")
        assert np.isfinite(exact).all()
        assert abs(exact.mean() - jL.mean()) <= 0.1 * jL.mean()


def _fog_box_grad_setup():
    z = np.load(os.path.join(DATA, "fogbox8_grad.npz"))
    res, spp = int(z["resolution"]), int(z["spp"])
    scene, camera = fog_box_scene(sigma_a=float(z["sigma_a"]), sigma_s=0.0,
                                  le_scale=float(z["le_scale"]),
                                  resolution=(res, res))
    steps = int(z["max_steps"])
    integ = VolPathIntegrator(
        max_depth=int(z["max_depth"]), rr_start_depth=int(z["rr_start_depth"]),
        use_nee=False, max_null_steps=steps, max_tr_steps=steps,
        differentiable=True)
    npix = res * res
    pixel = torch.arange(npix).repeat(spp)
    sample = torch.arange(spp).repeat_interleave(npix)
    o, d, wl = camera_rays(camera, pixel, sample, int(z["seed"]),
                           n_spectrum=int(z["n_spectrum"]))

    def loss(sa_scale):
        s = scene.replace(medium=scene.medium.replace(sigma_a_scale=sa_scale))
        return integ.trace(s, o, d, wl, pixel, sample, int(z["seed"])).mean()

    return z, scene, loss


def test_sigma_a_gradient_matches_reference_and_fd():
    z, scene, loss = _fog_box_grad_setup()
    theta = scene.medium.sigma_a_scale
    assert float(theta) == float(z["sigma_a_scale"])
    leaf = theta.clone().requires_grad_(True)
    value = loss(leaf)
    (grad,) = torch.autograd.grad(value, leaf)
    g = float(grad)
    want = float(z["grad_sigma_a_scale"])
    print(f"fog box: loss {float(value)} / {float(z['loss'])}, d/d sigma_a "
          f"{g} / {want}")
    assert abs(float(value) - float(z["loss"])) <= 1e-4 * abs(float(z["loss"]))
    assert abs(g - want) <= 1e-3 * abs(want)
    # tests/test_gradients.py's gate: central differences at two steps.
    with torch.no_grad():
        fd = np.mean([(float(loss(theta + eps)) - float(loss(theta - eps)))
                      / (2 * eps) for eps in (0.05, 0.1)])
    assert g < 0 and fd < 0, (g, fd)
    assert abs(fd - g) <= 0.35 * max(abs(fd), abs(g)), (g, fd)


_MEDIA_TEXT = """
Integrator "path" "integer maxdepth" 4
LookAt 0 1 -4  0 1 0  0 1 0
Camera "perspective" "float fov" 40
Film "rgb" "integer xresolution" 6 "integer yresolution" 6
WorldBegin
MakeNamedMedium "box" "string type" "homogeneous" "rgb sigma_a" [0.2 0.3 0.4]
  "rgb sigma_s" [1 0.5 0.25] "float g" 0.3 "float scale" 2
  "point3 p0" [-1 0 -1] "point3 p1" [1 2 1]
MakeNamedMedium "smoke" "string type" "uniformgrid" "integer nx" 3
  "integer ny" 2 "integer nz" 2
  "float density" [0 0.5 1 2 0.1 0 1 1 0.3 0 0 4]
  "rgb sigma_a" [0.5 0.5 0.5] "rgb Le" [1 0.5 0.2] "float Lescale" 3
  "point3 p0" [-1 0 -1] "point3 p1" [1 2 1]
MakeNamedMedium "sky" "string type" "cloud" "rgb sigma_s" [2 2 2]
  "float wispiness" 1.5 "point3 p0" [-2 0 -2] "point3 p1" [2 3 2]
MakeNamedMedium "tint" "string type" "rgbgrid" "integer nx" 2 "integer ny" 1
  "integer nz" 1 "rgb sigma_a" [1 2 3 4 5 6] "float scale" 0.5
MakeNamedMedium "ink" "string type" "homogeneous" "rgb sigma_a" [2 2 2]
  "rgb sigma_s" [0 0 0]
MakeNamedMedium "thin" "string type" "homogeneous" "rgb sigma_a" [1 1 1]
MediumInterface "{scene_medium}" ""
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Shape "trianglemesh" "point3 P" [-3 -3 3  3 -3 3  3 3 3  -3 3 3]
    "integer indices" [0 2 1 0 3 2]
AttributeEnd
AttributeBegin
  MediumInterface "thin" ""
  Material "{material}"
  Shape "sphere" "float radius" 0.5
  MediumInterface "ink" "thin"
  Shape "sphere" "float radius" 0.25
AttributeEnd
Shape "sphere" "float radius" 0.1
"""


def test_parsed_media_match_reference():
    """Every MakeNamedMedium kind (homogeneous with and without p0 / p1,
    uniformgrid with Le, cloud, rgbgrid) builds the reference's medium
    table for table; a MediumInterface naming a bounded medium binds it at
    the scene level, and nested interior media clone the material per
    interface; the path integrator becomes volpath with the reference's
    warning."""
    from pbrt_tpu.io.parser import PbrtParser as JaxParser
    from pbrt_tpu_torch.io.parser import PbrtParser

    text = _MEDIA_TEXT.format(scene_medium="smoke", material="")
    jp, pp = JaxParser().parse_string(text), PbrtParser().parse_string(text)
    assert set(pp.named_media) == set(jp.named_media) == {
        "box", "smoke", "sky", "tint", "ink", "thin"}
    assert pp.named_media_idx == jp.named_media_idx == {"ink": 0, "thin": 1}
    for name, med in jp.named_media.items():
        want, want_static = flatten_jax(med)
        got, got_static = flatten_jax(pp.named_media[name])
        assert got_static == want_static, name
        for path, value in want.items():
            np.testing.assert_array_equal(got[path], value, err_msg=name + path)
    # The material rows, the interface clones among them, as the
    # reference's parser lists them.
    assert pp.materials == jp.materials and pp.any_interface
    ps, _, pset = pp.build()
    assert ps.medium is pp.named_media["smoke"] and ps.medium.kind == "grid"
    assert ps.media_stack.n_media == 2
    # The two interfaced spheres' clones: (thin, vacuum) and (ink, thin).
    pairs = set(zip(ps.materials.med_inside.tolist(),
                    ps.materials.med_outside.tolist()))
    assert {(1, MED_VACUUM), (0, 1)} <= pairs
    assert isinstance(pset["integrator"], VolPathIntegrator)
    assert pset["warnings"] == ["scene has media; integrator upgraded to "
                                "volpath"]


@pytest.mark.parametrize("material", ["", "none", "interface"])
def test_material_less_boundaries(material):
    """Material "", "none" and "interface" are the passthrough boundary,
    shaded (MAT_INTERFACE in the referenced kinds); a scene-level cloud
    binds through MediumInterface."""
    text = _MEDIA_TEXT.format(scene_medium="sky", material=material)
    ps, _, _ = load_pbrt_string(text, device="cpu")
    assert ps.medium.kind == "cloud"
    assert int(ps.materials.kind[-1]) == MAT_INTERFACE
    assert MAT_INTERFACE in ps.shaded_kinds


def test_path_integrator_refuses_media():
    scene, camera = fog_box_scene()
    pixel = torch.arange(4)
    o, d, wl = camera_rays(camera, pixel, 0, 0, n_spectrum=8)
    with pytest.raises(ValueError, match="VolPathIntegrator"):
        PathIntegrator().trace(scene, o, d, wl, pixel, 0, 0)


# --- tests/test_medium_interface.py's gates, on the port alone -------------

_QUAD = ('Shape "trianglemesh" "point3 P" '
         "[-2 -2 2  2 -2 2  2 2 2  -2 2 2] "
         '"integer indices" [0 2 1 0 3 2]\n')


def _scene_text(spheres: str) -> str:
    return (
        'Integrator "volpath" "integer maxdepth" 10\n'
        'Film "rgb" "integer xresolution" 9 "integer yresolution" 9\n'
        "LookAt 0 0 -3  0 0 0  0 1 0\n"
        'Camera "perspective" "float fov" 20\n'
        "WorldBegin\n"
        'MakeNamedMedium "ink" "string type" "homogeneous" '
        '"rgb sigma_a" [2 2 2] "rgb sigma_s" [0 0 0]\n'
        'MakeNamedMedium "thin" "string type" "homogeneous" '
        '"rgb sigma_a" [1 1 1] "rgb sigma_s" [0 0 0]\n'
        + spheres
        + "AttributeBegin\n"
        '  AreaLightSource "diffuse" "rgb L" [10 10 10]\n'
        + _QUAD + "AttributeEnd\n")


def _sphere(material, interface='"ink" ""', radius=0.5):
    return ("AttributeBegin\n"
            f"  MediumInterface {interface}\n"
            f"  Material {material}\n"
            f'  Shape "sphere" "float radius" {radius}\n'
            "AttributeEnd\n")


def _centre(text, spp, seed=5):
    """The 9x9 render's centre pixel: the mean RGB of its spp samples."""
    scene, camera, settings = load_pbrt_string(text, device="cpu")
    pixel = torch.full((spp,), 40)
    sample = torch.arange(spp)
    o, d, wl, _ = camera_rays_full(camera, pixel, sample, seed, n_spectrum=8)
    L = settings["integrator"].trace(scene, o, d, wl, pixel, sample, seed)
    return float(spectrum_to_rgb(L, wl).mean()), scene


@pytest.fixture(scope="module")
def vacuum_centre():
    return _centre(_scene_text(""), 64)[0]


@pytest.mark.parametrize("material", ['"dielectric" "float eta" 1.0',
                                      '"none"'])
def test_absorbing_interior_beer_lambert(vacuum_centre, material):
    """The centre ray crosses the r = 0.5 ink sphere (sigma_a 2, chord 1):
    exp(-2) of the empty scene, through an eta = 1 dielectric and through
    a material-less (passthrough) boundary."""
    got, scene = _centre(_scene_text(_sphere(material)), 64)
    assert scene.media_stack.n_media == 2
    ratio = got / vacuum_centre
    assert abs(ratio - np.exp(-2.0)) < 0.03, ratio
    if material == '"none"':
        assert (scene.materials.kind == MAT_INTERFACE).any()


def test_nested_media_switching(vacuum_centre):
    """A thin (sigma 1) shell r in [0.25, 0.5] around an ink (sigma 2)
    core: the centre chord's optical depth is 1.5."""
    spheres = ("AttributeBegin\n"
               '  MediumInterface "thin" ""\n'
               '  Material "dielectric" "float eta" 1.0\n'
               '  Shape "sphere" "float radius" 0.5\n'
               '  MediumInterface "ink" "thin"\n'
               '  Shape "sphere" "float radius" 0.25\n'
               "AttributeEnd\n")
    got, _ = _centre(_scene_text(spheres), 384)
    assert abs(got / vacuum_centre - np.exp(-1.5)) < 0.05


def test_scattering_interior_finite_and_dimmer(vacuum_centre):
    """A scattering interior stays finite and non-negative over the image
    (32 spp in one pass) and dims the centre against vacuum."""
    text = _scene_text(_sphere('"dielectric" "float eta" 1.0', '"fog" ""'))
    text = text.replace(
        'MakeNamedMedium "ink"',
        'MakeNamedMedium "fog" "string type" "homogeneous" '
        '"rgb sigma_s" [3 3 3] "rgb sigma_a" [0 0 0] "float g" 0.4\n'
        'MakeNamedMedium "ink"')
    scene, camera, settings = load_pbrt_string(text, device="cpu")
    from pbrt_tpu_torch.render import render

    img = render(scene, camera, settings["integrator"], spp=32,
                 samples_per_pass=32, seed=1, n_spectrum=8, device="cpu")
    assert torch.isfinite(img).all() and (img >= 0).all()
    assert float(img[4, 4].mean()) < vacuum_centre
