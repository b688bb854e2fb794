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
GOLDENS = sorted(os.path.basename(p) for p in
                 glob.glob(os.path.join(ROOT, "tests", "goldens", "*.pbrt")))
# What each golden scene needs that the port lacks: its ROADMAP Queue 1
# item (the first such feature in the file), or None when it builds.
GOLDEN_ITEMS = {
    "bdpt.pbrt": 13, "box.pbrt": None, "conductor.pbrt": 8,
    "dielectric.pbrt": 11, "envmap.pbrt": 11, "fog.pbrt": 13,
    "imagetex.pbrt": 11, "mlt.pbrt": 13, "plymesh.pbrt": 11,
    "spheres.pbrt": 11, "spot.pbrt": 11, "sppm.pbrt": 13, "texture.pbrt": 11,
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
# tests/test_instancing.py's scene, lit by an area and an infinite light
# (the port has no point light yet), with a conductor and a non-uniform
# scale, a reversed and a flattened emissive object.
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
        if path in ("sweep.ibox", "sweep.irange"):  # derived by the port
            continue
        np.testing.assert_array_equal(value, want[path], err_msg=path)
    for path in set(want) - set(got):
        assert not np.any(want[path]), path
    for path, value in got_static.items():
        assert value == want_static[path], path
    np.testing.assert_array_equal(pc.camera_to_world.m.numpy(),
                                  np.asarray(jc.camera_to_world.m))
    np.testing.assert_allclose(pc.camera_to_world.m_inv.numpy(),
                               np.asarray(jc.camera_to_world.m_inv),
                               rtol=1e-6, atol=1e-6)
    assert (pc.resolution, pc.fov_deg) == (jc.resolution, jc.fov_deg)
    assert pset["integrator"].max_depth == jset["integrator"].max_depth
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
    ('Camera "realistic"', 14),
    ('Film "gbuffer"', 14),
    ('Sampler "sobol"', 14),
    ('Integrator "volpath"', 13),
    ('Texture "t" "spectrum" "checkerboard"', 10),
    ('Material "diffuse" "texture reflectance" "t"', 10),
    ('Material "dielectric"', 10),
    ('Material "coatedconductor"', 10),
    ('LightSource "point"', 11),
    ('LightSource "distant"', 11),
    ('LightSource "infinite" "string filename" "sky.exr"', 11),
    ('MakeNamedMedium "fog" "string type" "homogeneous"', 12),
    ('MediumInterface "fog" ""', 12),
    ('Shape "sphere"', 8),
    ('Shape "bilinearmesh"', 8),
    ('Shape "loopsubdiv"', 8),
    (_TRI + ' "float alpha" 0.5', 7),
    # An instance whose two keyframes differ is animated.
    (_BOX.replace("box", "b") + 'ActiveTransform EndTime Translate 1 0 0 '
     'ObjectInstance "b"', 7),
], ids=["camera", "film", "sampler", "integrator", "texture",
        "texture_param", "dielectric", "coated_conductor", "point_light",
        "distant_light", "envmap", "medium", "medium_interface", "sphere",
        "bilinear", "subdivision", "alpha", "animated_instance"])
def test_unported_features_raise(text, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
        load_pbrt_string(text, device="cpu")


def test_reference_approximations_warn():
    text = 'Material "wood" ' + _TRI + ' Shape "nurbs" LightSource "exotic"'
    scene, _, settings = load_pbrt_string(text, device="cpu")
    assert scene.geom.num_triangles == 1 and scene.small is not None
    assert settings["warnings"] == list(
        jax_load_pbrt_string(text)[2]["warnings"])
    assert "material wood approximated as diffuse" in settings["warnings"]


def test_cuda_device_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_pbrt_string(_TRI)
