"""The port's .pbrt parser against the reference's on the CPU: the same
files give the same triangles, materials, lights, camera, settings and
sweep tables (bit for bit), every golden scene file either builds the
reference's scene or names the ROADMAP item it waits for, and a feature
the port lacks raises instead of rendering without it."""

import glob
import os
import tempfile

import numpy as np
import pytest
import torch

from pbrt_tpu.io.parser import load_pbrt as jax_load_pbrt
from pbrt_tpu.io.parser import load_pbrt_string as jax_load_pbrt_string
from pbrt_tpu.io.parser import tokenize as jax_tokenize
from pbrt_tpu_torch.convert import scene_from_arrays
from pbrt_tpu_torch.io.parser import load_pbrt, load_pbrt_string, tokenize

from .torch_port_helpers import flatten_jax
from .torch_port_instanced import SMALL, field_text, write_field_meshes

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_NVDB = os.path.join(ROOT, "tests", "data", "torch_port", "io",
                          "smoke.nvdb")
GOLDENS = sorted(os.path.basename(p) for p in
                 glob.glob(os.path.join(ROOT, "tests", "goldens", "*.pbrt")))
# What each golden scene needs that the port lacks: its ROADMAP Queue 1
# item (the first such feature in the file), or None when it builds.
GOLDEN_ITEMS = {
    "bdpt.pbrt": None, "box.pbrt": None, "conductor.pbrt": None,
    "dielectric.pbrt": None, "envmap.pbrt": None, "fog.pbrt": None,
    "imagetex.pbrt": None, "mlt.pbrt": None, "plymesh.pbrt": None,
    "spheres.pbrt": None, "spot.pbrt": None, "sppm.pbrt": None,
    "texture.pbrt": None,
}

_BOX = """
ObjectBegin "box"
  Shape "trianglemesh"
    "point3 P" [ -0.5 -0.5 -0.5   0.5 -0.5 -0.5   0.5 0.5 -0.5   -0.5 0.5 -0.5
                 -0.5 -0.5 0.5    0.5 -0.5 0.5    0.5 0.5 0.5    -0.5 0.5 0.5 ]
    "integer indices" [ 0 1 2  0 2 3   4 6 5  4 7 6   0 4 5  0 5 1
                        3 2 6  3 6 7   0 3 7  0 7 4   1 5 6  1 6 2 ]
ObjectEnd
"""
# tests/test_instancing.py's scene, lit by an area and an infinite light,
# with a conductor and a non-uniform scale, a reversed and a flattened
# emissive object.
_HEAD = """
LookAt 0 3 -8  0 0 2  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [32] "integer yresolution" [24]
Sampler "random" "integer pixelsamples" 8
Integrator "simplepath" "integer maxdepth" 4
WorldBegin
LightSource "infinite" "rgb L" [0.2 0.2 0.25]
ObjectBegin "lamp"
  AreaLightSource "diffuse" "rgb L" [10 10 10] "bool twosided" true
  Shape "trianglemesh" "point3 P" [-1 6 -1 1 6 -1 1 6 1 -1 6 1]
    "integer indices" [0 1 2 0 2 3]
ObjectEnd
ObjectInstance "lamp"
Material "matte" "rgb reflectance" [0.4 0.5 0.6]
AttributeBegin
  ReverseOrientation
  Shape "trianglemesh" "point3 P" [-6 -1 -6 6 -1 -6 6 -1 6]
    "integer indices" [0 1 2] "point2 uv" [0 0 1 0 1 1]
AttributeEnd
MakeNamedMaterial "copper" "string type" "conductor" "float roughness" 0.1
NamedMaterial "copper"
"""


def _box_text(n=5):
    body = _HEAD + _BOX
    for i in range(n):
        scale = "Scale 1.5 0.5 1" if i % 3 == 0 else ""
        body += f"""
AttributeBegin
  Translate {i * 2 - 4} 0 3
  Rotate {i * 30} 0 1 0
  {scale}
  ObjectInstance "box"
AttributeEnd
"""
    return body


def _assert_same_build(jax_built, port_built):
    """Every array the reference scene carries equals the port's, bit for
    bit (what the port does not carry is empty or zero); the camera and
    the settings agree."""
    (js, jc, jset), (ps, pc, pset) = jax_built, port_built
    want, want_static = flatten_jax(js)
    got, got_static = flatten_jax(ps)
    for path, value in got.items():
        if path in ("sweep.ibox", "sweep.irange", "sweep.gbox"):  # derived
            continue
        if path.startswith("anim.xforms."):  # stacked by instance
            name = path.rsplit(".", 1)[1]
            want[path] = np.stack([np.asarray(x) for p, x in sorted(
                want.items()) if p.startswith("anim.xforms.")
                and p.endswith("." + name) and p.count(".") == 3])
        np.testing.assert_array_equal(value, want[path], err_msg=path)
    for path in set(want) - set(got):
        assert path.startswith("anim.xforms.") or not np.any(want[path]), path
    for path, value in got_static.items():
        if path.startswith("anim.xforms."):
            assert value == want_static[path.replace("xforms.", "xforms.0.")]
            continue
        assert value == want_static[path], path
    np.testing.assert_array_equal(pc.camera_to_world.m.numpy(),
                                  np.asarray(jc.camera_to_world.m))
    np.testing.assert_allclose(pc.camera_to_world.m_inv.numpy(),
                               np.asarray(jc.camera_to_world.m_inv),
                               rtol=1e-6, atol=1e-6)
    assert (pc.resolution, pc.fov_deg) == (jc.resolution, jc.fov_deg)
    # The integrator: the same class, and every setting both carry equal
    # (MLT's base path integrator's included; the port's own switches,
    # such as the volumetric path's compact_walks, aside).
    assert (type(pset["integrator"]).__name__
            == type(jset["integrator"]).__name__)
    _, got_integ = flatten_jax(pset["integrator"])
    _, want_integ = flatten_jax(jset["integrator"])
    shared = got_integ.keys() & want_integ.keys()
    assert shared
    for path in shared:
        assert got_integ[path] == want_integ[path], path
    for key in ("spp", "sampler", "warnings"):
        assert pset[key] == jset[key], key


def test_tokenizer_matches():
    text = field_text() + _box_text() + '# comment "x"\nShape"a"[1 2]#c\n'
    assert tokenize(text) == list(jax_tokenize(text))


def test_instanced_box_file_matches_jax():
    text = _box_text()
    jax_built = jax_load_pbrt_string(text)
    port_built = load_pbrt_string(text, device="cpu")
    _assert_same_build(jax_built, port_built)
    ps, _, pset = port_built
    # 12 prototype triangles stored once; the flattened lamp and the floor
    # are the root geometry, instance 0.
    assert ps.geom.num_triangles == 3 + 12
    assert ps.sweep.instanced and ps.sweep.n_instances == 6
    assert ps.small is None and ps.clusters is None
    assert ps.lights.n_area == 2 and ps.lights.has_infinite
    assert any("flattened" in w for w in pset["warnings"])
    assert any("matte approximated" in w for w in pset["warnings"])


def test_instanced_plymesh_file_matches_jax():
    """The instanced field with small prototypes: plymesh, two prototypes,
    36 instances; the converted reference tables equal the port's."""
    with tempfile.TemporaryDirectory() as tmp:
        write_field_meshes("pbrt_tpu_torch", tmp, SMALL)
        jax_built = jax_load_pbrt_string(field_text(), tmp)
        port_built = load_pbrt_string(field_text(), tmp, device="cpu")
    _assert_same_build(jax_built, port_built)
    ps = port_built[0]
    assert ps.sweep.n_instances == 37 and ps.shaded_kinds == {0, 1}
    conv = scene_from_arrays(*flatten_jax(jax_built[0]))
    for path, value in flatten_jax(ps.sweep)[0].items():
        assert torch.equal(getattr(conv.sweep, path), torch.as_tensor(value)), path


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_scene_files(name):
    path = os.path.join(ROOT, "tests", "goldens", name)
    item = GOLDEN_ITEMS[name]
    if item is None:
        _assert_same_build(jax_load_pbrt(path), load_pbrt(path, device="cpu"))
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
        load_pbrt(path, device="cpu")


_TRI = ('Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] '
        '"integer indices" [0 1 2]')


@pytest.mark.parametrize("text, item", [
    # Every camera, film and sampler of the reference is ported (item 14);
    # the file entry refuses a lens camera without its lens, a film other
    # than rgb and a sampler name the reference lacks (the reference
    # renders perspective, RGB and independent instead).
    ('Camera "realistic"', 'needs a "string lensfile"'),
    ('Film "gbuffer"', "Film 'gbuffer'"),
    ('Sampler "owen"', "unknown Sampler 'owen'"),
    # Every integrator of the reference builds
    # (tests/test_torch_integrators_misc.py); a name the reference renders
    # as a path trace raises ValueError.
    ('Integrator "aov"', "unknown Integrator 'aov'"),
    # Ptex textures, every image format and NanoVDB media are read
    # (tests/test_torch_io.py); a file that cannot be read raises ValueError
    # naming it, where the reference binds gray, renders the light's
    # constant L or skips the medium.
    ('Texture "t" "spectrum" "ptex" "string filename" "t.ptx"',
     "ptex file 't.ptx' cannot be read"),
    # The reference has no texture-typed material parameter but the
    # albedo: its parser takes float() of the texture's name, and the
    # port's raises ValueError.
    ('Texture "t" "float" "constant" "float value" 0.2 '
     'Material "conductor" "texture roughness" "t"', ValueError),
    ('Texture "t" "float" "fbm" '
     'Material "dielectric" "texture roughness" "t"', ValueError),
    # Every material family parses (tests/test_torch_coated.py,
    # tests/test_torch_families.py), the coat's roughness not as a texture.
    ('Texture "r" "float" "constant" "float value" 0.2 '
     'Material "coatedconductor" "texture interface.roughness" "r"',
     ValueError),
    ('LightSource "infinite" "string filename" "sky.exr"',
     "light image 'sky.exr' cannot be read"),
    # Every medium kind builds (tests/test_torch_volpath.py,
    # tests/test_torch_io.py); a NanoVDB file that cannot be read raises,
    # and so does one without the grid a MediumInterface's medium names.
    ('MakeNamedMedium "fog" "string type" "nanovdb" '
     '"string filename" "fog.nvdb"', "'fog.nvdb' cannot be read"),
    ('MakeNamedMedium "v" "string type" "nanovdb" "string filename" '
     f'"{SMOKE_NVDB}" "string gridname" "temperature" MediumInterface "v" ""',
     "the grid 'temperature'"),
    # Every shape family builds (tests/test_torch_shapes.py), but no
    # analytic one inside an object: the reference draws it once in world
    # space, carried by no instance (a departure, ROADMAP Queue 3).
    ('ObjectBegin "s" Shape "sphere" ObjectEnd', "inside ObjectBegin"),
    ('ObjectBegin "s" Shape "bilinearmesh" "point3 P" [0 0 0 1 0 0 0 1 0 '
     '1 1 0] ObjectEnd', "inside ObjectBegin"),
    ('ObjectBegin "s" Shape "curve" "point3 P" [0 0 0 0 1 0 0 2 0 0 3 0] '
     'ObjectEnd', "inside ObjectBegin"),
    ('ObjectBegin "s" Shape "disk" ObjectEnd', "inside ObjectBegin"),
    ('Camera "orthographic"', "Camera 'orthographic'"),
], ids=["camera", "film", "sampler", "integrator", "texture",
        "texture_param", "dielectric", "coated_conductor", "envmap",
        "medium", "medium_interface", "sphere", "bilinear", "curve_in_object",
        "disk_in_object", "orthographic"])
def test_unported_features_raise(text, item):
    if isinstance(item, str):
        with pytest.raises(ValueError, match=item):
            load_pbrt_string(text, device="cpu")
        return
    if item is ValueError:
        with pytest.raises(ValueError, match="the reference has no "
                           "texture-typed roughness, eta"):
            load_pbrt_string(text, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
        load_pbrt_string(text, device="cpu")


_FAMILIES = """
MakeNamedMaterial "a" "string type" "diffuse" "rgb reflectance" [0.7 0.2 0.1]
MakeNamedMaterial "b" "string type" "coateddiffuse" "float roughness" 0.2
Material "mix" "string materials" ["a" "b"] "float amount" 0.25
Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] "integer indices" [0 1 2]
Material "hair" "float beta_m" 0.25 "float beta_n" 0.4 "float alpha" 3
  "float eumelanin" 0.8 "float pheomelanin" 0.3
Shape "trianglemesh" "point3 P" [0 0 1 1 0 1 0 1 1] "integer indices" [0 1 2]
Material "hair" "rgb sigma_a" [0.2 0.4 0.9]
Shape "trianglemesh" "point3 P" [0 0 2 1 0 2 0 1 2] "integer indices" [0 1 2]
Material "subsurface" "rgb mfp" [0.1 0.2 0.3] "float eta" 1.4
Shape "trianglemesh" "point3 P" [0 0 3 1 0 3 0 1 3] "integer indices" [0 1 2]
Material "subsurface" "rgb sigma_s" [1 2 3]
Shape "trianglemesh" "point3 P" [0 0 4 1 0 4 0 1 4] "integer indices" [0 1 2]
Material "retroreflective" "float roughness" 0.2 "string conductor" "Au"
Shape "trianglemesh" "point3 P" [0 0 5 1 0 5 0 1 5] "integer indices" [0 1 2]
"""


def test_material_families_match_jax():
    """hair (pigment and sigma_a), subsurface (mfp, and sigma_s over the
    default sigma_a), a mix over a diffuse and a coated material and
    retroreflective gold parse to the reference's tables, bit for bit (the
    measured family: tests/test_torch_families.py)."""
    built = load_pbrt_string(_FAMILIES, device="cpu")
    _assert_same_build(jax_load_pbrt_string(_FAMILIES), built)
    assert built[0].shaded_kinds == {0, 4, 7, 8, 10, 11}


@pytest.mark.parametrize("text, match", [
    ('Material "measured" "string filename" "missing.bsdf"', "cannot read"),
    ('Material "measured"', "without a"),
    ('MakeNamedMaterial "a" "string type" "diffuse" '
     'Material "mix" "string materials" ["a" "nowhere"]', "undefined"),
], ids=["measured_unreadable", "measured_no_file", "mix_undefined"])
def test_material_departures_raise(text, match):
    """Loud where the reference warns and binds a gray table or a diffuse
    fallback (ROADMAP Queue 3's departures)."""
    with pytest.raises(ValueError, match=match):
        load_pbrt_string(text, device="cpu")


# Every light directive of the reference, through a CTM; emissive spheres
# as sphere lights, and as icospheres when reversed or inside an object.
_LIGHTS = """
LookAt 0 2 -6  0 0.5 0  0 1 0
Camera "perspective" "float fov" 40
WorldBegin
AttributeBegin
  Translate 0.5 0 0
  Rotate 30 0 1 0
  LightSource "point" "point3 from" [2 4 -3] "rgb I" [30 30 30]
  LightSource "spot" "point3 from" [0 4 -1] "point3 to" [0 0 0]
    "rgb I" [60 55 50] "float coneangle" 35 "float conedeltaangle" 10
  LightSource "spot" "rgb I" [5 5 5] "float scale" 2
  LightSource "distant" "point3 from" [-1 2 -1] "point3 to" [0 0 0]
    "rgb L" [1.5 1.4 1.2]
  LightSource "projection" "float fov" 50 "string filename" "slide.pfm"
  LightSource "goniometric" "point3 from" [0 3 0] "rgb I" [2 2 2]
AttributeEnd
LightSource "infinite" "rgb L" [0.2 0.2 0.25]
Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-6 0 -6  6 0 -6  6 0 6  -6 0 6]
Shape "sphere" "float radius" 0.3
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 3 2]
  Translate 1 1 0
  Scale 0.5 0.5 0.5
  Shape "sphere" "float radius" 0.4
  ReverseOrientation
  Shape "sphere" "float radius" 0.2
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [1 1 1] "bool twosided" true
  Translate -1 0.5 1
  Shape "sphere" "float radius" 0.25
AttributeEnd
ObjectBegin "lamp"
  AreaLightSource "diffuse" "rgb L" [2 2 2]
  Shape "sphere" "float radius" 0.1
ObjectEnd
"""


def test_light_directives_match_jax(tmp_path):
    """Point, spot (with and without "to"), distant, projection over an
    image, goniometric and infinite lights under a rotated CTM, a plain
    sphere, two sphere lights, a reversed emissive sphere and one inside
    an object (icospheres), bit for bit with the reference's build,
    including the light ids the geometry carries."""
    img = np.random.default_rng(0).gamma(1.0, size=(6, 10, 3))
    with open(tmp_path / "slide.pfm", "wb") as f:
        f.write(b"PF\n10 6\n-1\n")
        f.write(np.flipud(img).astype("<f4").tobytes())
    jax_built = jax_load_pbrt_string(_LIGHTS, str(tmp_path))
    port_built = load_pbrt_string(_LIGHTS, str(tmp_path), device="cpu")
    _assert_same_build(jax_built, port_built)
    ps = port_built[0]
    lights = ps.lights
    assert (lights.n_point, lights.n_spot, lights.n_distant, lights.n_proj,
            lights.n_gonio, lights.n_sphl) == (1, 2, 1, 1, 1, 2)
    assert lights.has_infinite and lights.n_lights == 9 + lights.n_area
    assert lights.n_area == 2 * 320  # the two icospheres' triangles
    np.testing.assert_array_equal(
        ps.geom.sph_light.numpy(), [-1, lights.n_area, lights.n_area + 1])


@pytest.mark.parametrize("light", [
    'LightSource "infinite" "string filename" "missing.pfm"',
    'LightSource "projection" "string filename" "missing.pfm"',
    'LightSource "goniometric" "string filename" "missing.pfm"',
])
def test_unreadable_light_image_raises(light):
    """A light image that cannot be read raises; the reference warns and
    renders the light with its constant I or L instead."""
    with pytest.raises(ValueError, match="missing.pfm"):
        load_pbrt_string(light, device="cpu")


def test_unknown_light_type_raises():
    """The reference warns and skips an unknown light type; the port stops,
    as pbrt-v4 does."""
    with pytest.raises(ValueError, match="unknown light type"):
        load_pbrt_string(_TRI + ' LightSource "exotic"', device="cpu")


def test_reference_approximations_warn():
    text = 'Material "wood" ' + _TRI + ' Shape "nurbs"'
    scene, _, settings = load_pbrt_string(text, device="cpu")
    assert scene.geom.num_triangles == 1 and scene.small is not None
    assert settings["warnings"] == list(
        jax_load_pbrt_string(text)[2]["warnings"])
    assert "material wood approximated as diffuse" in settings["warnings"]


# Every ported Texture class, each mapping, references two levels deep, a
# reference before the texture's definition (ignored with a warning, as
# in the reference) and the three glass material names.
_TEXTURES = """
LookAt 0 2 -6  0 0.5 0  0 1 0
Camera "perspective" "float fov" 40
WorldBegin
Material "diffuse" "texture reflectance" "late"
Texture "c" "spectrum" "constant" "rgb value" [0.2 0.4 0.6]
Texture "k" "spectrum" "checkerboard" "rgb tex1" [0.9 0.1 0.1]
  "rgb tex2" [0.1 0.1 0.9] "float uscale" 4 "float vscale" 3
Texture "ks" "spectrum" "checker" "string mapping" "spherical"
  "texture tex1" "k" "texture tex2" "c"
Texture "kc" "spectrum" "checkerboard" "string mapping" "cylindrical"
  "float udelta" 0.5
Texture "kp" "spectrum" "checkerboard" "string mapping" "planar"
  "vector3 v1" [1 0.5 0] "vector3 v2" [0 0.2 1]
Texture "s" "spectrum" "scale" "texture tex" "ks" "float scale" 0.5
Texture "sa" "spectrum" "scale" "rgb tex" [1 0.5 0.25] "float scale" 2
Texture "m" "spectrum" "mix" "texture tex1" "s" "rgb tex2" [0 1 0]
  "float amount" 0.25
Texture "dm" "spectrum" "directionmix" "texture tex1" "c" "texture tex2" "k"
  "vector3 dir" [0 1 0]
Texture "b" "spectrum" "bilerp" "rgb v00" [1 0 0] "rgb v11" [0 0 1]
Texture "d" "spectrum" "dots" "rgb inside" [1 1 0] "float uscale" 3
Texture "f" "float" "fbm"
Texture "w" "float" "wrinkled"
Texture "y" "float" "windy"
Texture "mb" "spectrum" "marble" "float scale" 2
Texture "i" "spectrum" "imagemap" "string filename" "img.pfm" "float scale" 2
Texture "late" "spectrum" "constant"
Material "diffuse" "texture reflectance" "m"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-6 0 -6  6 0 -6  6 0 6  -6 0 6] "point2 uv" [0 0 1 0 1 1 0 1]
MakeNamedMaterial "img" "string type" "diffuse" "texture albedo" "i"
NamedMaterial "img"
Shape "sphere" "float radius" 0.3
Material "dielectric" "float eta" 1.33 "float roughness" 0.1
Shape "sphere" "float radius" 0.5
Material "glass"
Shape "sphere" "float radius" 0.7
Material "thindielectric" "float eta" 1.4
Shape "sphere" "float radius" 0.9
"""


def _write_pfm(path, img):
    with open(path, "wb") as f:
        f.write(f"PF\n{img.shape[1]} {img.shape[0]}\n-1\n".encode())
        f.write(np.flipud(img).astype("<f4").tobytes())


def test_texture_directives_match_jax(tmp_path):
    """The texture rows, the flat texel table and the materials that bind
    them, bit for bit with the reference's build; convert.py carries the
    reference's tables to the same tensors."""
    _write_pfm(tmp_path / "img.pfm",
               np.random.default_rng(1).uniform(0, 1, (5, 9, 3)))
    jax_built = jax_load_pbrt_string(_TEXTURES, str(tmp_path))
    port_built = load_pbrt_string(_TEXTURES, str(tmp_path), device="cpu")
    _assert_same_build(jax_built, port_built)
    ps, _, pset = port_built
    t = ps.textures
    assert t.n_textures == 17 and t.has_refs and t.img_flat.shape[0] == 1
    assert ps.materials.albedo_tex.tolist()[1:4] == [-1, 7, 15]
    assert ps.shaded_kinds == {0, 2, 3}
    assert "texture 'late' referenced before definition; ignored" in pset["warnings"]
    conv = scene_from_arrays(*flatten_jax(jax_built[0]))
    for path, value in flatten_jax(t)[0].items():
        assert torch.equal(getattr(conv.textures, path),
                           torch.as_tensor(value)), path


def test_texture_typed_amounts_bind_sub_textures():
    """A texture-typed scale or mix amount binds through sub2, as the
    reference's tables mean it to; the reference's parser takes float() of
    the texture's name and raises (ROADMAP Queue 3)."""
    text = ('Texture "k" "spectrum" "checkerboard" '
            'Texture "s" "spectrum" "scale" "rgb tex" [1 0.5 0.25] '
            '"texture scale" "k" '
            'Texture "m" "spectrum" "mix" "texture tex1" "s" '
            '"texture amount" "k"')
    with pytest.raises(ValueError, match="could not convert"):
        jax_load_pbrt_string(text)
    t = load_pbrt_string(text, device="cpu")[0].textures
    assert t.sub2.tolist() == [-1, 0, 0] and t.sub0.tolist() == [-1, -1, 1]
    assert t.f0.tolist() == [1.0, 1.0, 0.5]


@pytest.mark.parametrize("text, error", [
    # The reference binds 0.5 gray and warns.
    ('Texture "t" "spectrum" "cloud"', "unknown texture class"),
    # The reference binds a 0.5 gray image and warns.
    ('Texture "t" "spectrum" "imagemap" "string filename" "missing.pfm"',
     "missing.pfm"),
    ('Texture "t" "spectrum" "imagemap"', "filename"),
], ids=["unknown_class", "missing_image", "no_filename"])
def test_texture_departures_raise(text, error):
    with pytest.raises(ValueError, match=error):
        load_pbrt_string(text, device="cpu")


def test_cuda_device_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_pbrt_string(_TRI)


@pytest.mark.parametrize("name", ["independent", "random", "stratified",
                                  "sobol", "paddedsobol", "zsobol", "halton",
                                  "pmj02bn"])
def test_sampler_names_map_as_reference(name):
    text = f'Sampler "{name}" "integer pixelsamples" 8\n'
    _, _, want = jax_load_pbrt_string(text)
    _, _, got = load_pbrt_string(text, device="cpu")
    assert (got["sampler"], got["spp"]) == (want["sampler"], want["spp"])


# The lens works in mm: the world-to-camera transform scales by 1000.
_LENS_SCENE = """
Scale 1000 1000 1000
LookAt 0.5 0.5 -1.45  0.5 0.5 0.5  0 1 0
Camera "{kind}" "string lensfile" "{lens}" "float filmdiag" 30
    {extra}
Sampler "zsobol" "integer pixelsamples" 4
Film "rgb" "integer xresolution" 8 "integer yresolution" 8
WorldBegin
AreaLightSource "diffuse" "rgb L" [4 4 4]
Shape "trianglemesh" "point3 P" [0 1 0  1 1 0  1 1 1  0 1 1]
    "integer indices" [0 1 2 0 2 3]
Material "diffuse" "rgb reflectance" [0.6 0.5 0.4]
Shape "trianglemesh" "point3 P" [-1 0 -1  2 0 -1  2 0 2  -1 0 2  -1 0 2  2 0 2  2 2 2  -1 2 2]
    "integer indices" [0 2 1 0 3 2 4 5 6 4 6 7]
"""


@pytest.mark.parametrize("lens", ["doublet.dat", "omni_microlens.json"])
def test_lens_camera_file_matches_reference(lens):
    from pbrt_tpu_torch.convert import camera_from_arrays
    from pbrt_tpu_torch.render import render_file

    kind = "omni" if lens.endswith(".json") else "realistic"
    extra = ('"bool diffractionEnabled" true "float microlenssensoroffset" '
             '0.002 "float aperturediameter" 5' if kind == "omni" else "")
    text = _LENS_SCENE.format(kind=kind, lens=lens, extra=extra)
    data = os.path.join(ROOT, "tests", "data", "torch_port")
    _, jcam, jset = jax_load_pbrt_string(text, data)
    scene, cam, settings = load_pbrt_string(text, data, device="cpu")
    assert type(cam).__name__ == type(jcam).__name__ == "RealisticCamera"
    assert settings["sampler"] == "zsobol"
    assert (cam.diffraction, cam.microlens is None) == (
        jcam.diffraction, jcam.microlens is None)
    assert any("aperturediameter" in w for w in settings["warnings"]) == (
        kind == "omni")
    conv = camera_from_arrays(*flatten_jax(jcam), kind="RealisticCamera")
    r = np.random.default_rng(6)
    pf = torch.from_numpy(r.uniform(0, 8, (2048, 2)).astype(np.float32))
    ul = torch.from_numpy(r.uniform(0, 1, (2048, 2)).astype(np.float32))
    for a, b in zip(cam.generate_rays(pf, ul), conv.generate_rays(pf, ul)):
        assert torch.equal(a, b)
    img = render_file(scene, cam, settings, n_spectrum=8, device="cpu")
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0.0


def test_lens_file_that_does_not_load_raises():
    text = _LENS_SCENE.format(kind="realistic", lens="missing.dat", extra="")
    with pytest.raises(ValueError, match="lensfile 'missing.dat'"):
        load_pbrt_string(text, device="cpu")
