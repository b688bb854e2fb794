"""The port's light tracer (pbrt_tpu_torch/models/lightpath.py), its
emission origins (LightBuffers.sample_le_origin) and the pinhole's
projection (PerspectiveCamera.project) against the reference on the CPU.

- sample_le_origin on numpy-seeded draws, over area triangles and sphere
  lights: the light ids bit for bit, points, normals, areas, pmfs and
  emission rows within rtol 1e-6 (float32 ulps: a cross product and a
  normalisation of two libraries).
- project, position and pixel_solid_angle_base: raster points within
  rtol 1e-6, cosines within 1e-6, the in-film mask equal.
- One render_splats pass (256 paths, depth 5) of tests/goldens/bdpt.pbrt's
  room at 16x16 against the reference's per-lane connections (committed
  by scripts/make_torch_port_golden_lighttransport.py): each connection's
  pixel equal and its RGB within rtol 1e-3 / atol 1e-5 on >= 99% of the
  lanes, and the splat image on >= 99% of its values; render_lightpath's
  image (4 passes) the same way.
- tests/test_lightpath.py's adjoint gate on the port: light tracing
  converges to the port's forward path trace of the Cornell box (the
  mean within 12%, the median 4x4-block error under 25%).
- A gradient request through the light tracer raises (item 5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.io.parser import load_pbrt_string as jax_load_pbrt_string
from pbrt_tpu_torch.core import spectrum
from pbrt_tpu_torch.io.parser import load_pbrt, load_pbrt_string
from pbrt_tpu_torch.models import lightpath
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.render import render
from pbrt_tpu_torch.samplers.samplers import Sampler
from pbrt_tpu_torch.scenes.cornell import cornell_box

from .torch_port_helpers import share_close

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_port")
ROOM = os.path.join(ROOT, "tests", "goldens", "bdpt.pbrt")

# Two area quads of different power and two sphere lights (one reversed
# nothing: both emit outward), so the renormalised pmf picks all kinds.
LIGHTS = """
LookAt 0 1 -4  0 1 0  0 1 0
Camera "perspective" "float fov" 45
Film "rgb" "integer xresolution" [24] "integer yresolution" [16]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 3 2]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-1 2 -1  1 2 -1  1 2 1  -1 2 1]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [1 1 1] "float scale" 3
  Shape "trianglemesh" "integer indices" [0 1 2]
    "point3 P" [0 0 2  1 0 2  0 1 2]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [2 5 1]
  Translate 1.5 0.5 0
  Shape "sphere" "float radius" 0.3
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "blackbody L" [3000]
  Translate -1.5 0.5 0.5
  Shape "sphere" "float radius" 0.2
AttributeEnd
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
"""


def _both(text):
    js, jc, _ = jax_load_pbrt_string(text)
    ps, pc, _ = load_pbrt_string(text, device="cpu")
    return js, jc, ps, pc


def test_sample_le_origin_matches_reference():
    js, _, ps, _ = _both(LIGHTS)
    assert ps.lights.n_area == 3 and ps.lights.n_sphl == 2
    rng = np.random.default_rng(5)
    n = 4096
    u_sel = rng.random(n, dtype=np.float32)
    u_pos = rng.random((n, 2), dtype=np.float32)
    want = js.lights.sample_le_origin(jnp.asarray(u_sel), jnp.asarray(u_pos))
    got = ps.lights.sample_le_origin(torch.from_numpy(u_sel),
                                     torch.from_numpy(u_pos))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    assert len(np.unique(got["idx"].numpy())) == 5
    np.testing.assert_array_equal(got["illum"].numpy(),
                                  np.asarray(want["illum"]))
    for key in ("p", "n", "area", "pmf", "coeffs", "scale"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


def test_sample_le_origin_needs_emitters():
    """Light paths start on emissive geometry only, as the reference's do:
    a scene with another kind of light raises (item 16), and one with no
    light at all raises ValueError."""
    head = LIGHTS.split("WorldBegin")[0] + "WorldBegin\n"
    for extra, err, match in (
            ('LightSource "point" "rgb I" [1 1 1]\n', NotImplementedError,
             "Queue 1 item 16"),
            (LIGHTS.split("WorldBegin")[1]
             + 'LightSource "infinite" "rgb L" [1 1 1]\n',
             NotImplementedError, "Queue 1 item 16"),
            ("", ValueError, "no emissive geometry")):
        _, _, ps, _ = _both(head + extra)
        with pytest.raises(err, match=match):
            ps.lights.sample_le_origin(torch.zeros(4), torch.zeros(4, 2))


def test_camera_projection_matches_reference():
    _, jc, _, pc = _both(LIGHTS)
    np.testing.assert_allclose(pc.position.numpy(), np.asarray(jc.position),
                               rtol=1e-6, atol=1e-7)
    assert pc.pixel_solid_angle_base() == pytest.approx(
        jc.pixel_solid_angle_base(), rel=1e-12)
    rng = np.random.default_rng(9)
    p = rng.uniform(-3, 3, (4096, 3)).astype(np.float32)
    want = jc.project(jnp.asarray(p))
    got = pc.project(torch.from_numpy(p))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < got[2].float().mean() < 1
    # project inverts generate_rays' raster mapping.
    px = torch.tensor([[3.25, 7.5], [20.0, 1.0]])
    o, d = pc.generate_rays(px)
    back, _, inside = pc.project(o + 2.0 * d)
    assert bool(inside.all())
    np.testing.assert_allclose(back.numpy(), px.numpy(), atol=2e-4)


def _room(res):
    scene, camera, _ = load_pbrt(ROOM, device="cpu")
    return scene, camera.replace(resolution=(res, res))


def test_lightpath_lanes_match_reference(monkeypatch):
    z = np.load(os.path.join(DATA, "lightpath16_lanes.npz"))
    res, n = int(z["cfg_resolution"]), int(z["paths"])
    scene, camera = _room(res)
    rows = []
    splat_rows = lightpath.splat_rows

    def record(*args, **kw):
        pix, contrib = splat_rows(*args, **kw)
        rows.append((pix.numpy(), contrib.numpy()))
        return pix, contrib

    monkeypatch.setattr(lightpath, "splat_rows", record)
    sampler = Sampler(seed=int(z["cfg_seed"]), kind="independent", spp=1)
    wl = spectrum.sample_visible(sampler.get_1d(torch.arange(n), 0, 5),
                                 int(z["cfg_n_spectrum"]))
    img = lightpath.LightPathIntegrator(
        max_depth=int(z["cfg_max_depth"])).render_splats(
            scene, camera, n, wl, 0, sampler)
    assert len(rows) == z["pix"].shape[0]
    for c, (pix, contrib) in enumerate(rows):
        same = float(np.mean(pix == z["pix"][c]))
        close, n_bad = share_close(contrib, z["contrib"][c], 1e-3, 1e-5)
        print(f"connection {c}: pixels {same:.4f}, RGB {close:.4f}")
        assert same >= 0.99 and close >= 0.99, (c, same, n_bad)
    assert (z["pix"] < res * res).sum() > 100  # connections that land
    got, n_bad = share_close(img.numpy(), z["image"], 1e-3, 1e-5)
    assert got >= 0.99, n_bad
    assert z["image"].mean() > 0.01


def test_render_lightpath_matches_reference():
    want = np.load(os.path.join(DATA, "lightpath16_spp4.npy"))
    scene, camera = _room(want.shape[0])
    img = lightpath.render_lightpath(scene, camera, n_paths_total=1024,
                                     paths_per_pass=256, seed=0,
                                     n_spectrum=8, device="cpu")
    assert img.shape == want.shape and bool(torch.isfinite(img).all())
    got, n_bad = share_close(img.numpy(), want, 1e-3, 1e-5)
    assert got >= 0.99, n_bad


def test_lightpath_matches_forward():
    """Eye paths with NEE and light paths splatted onto the camera, two
    different estimators, converge to the same image."""
    scene, camera = cornell_box(resolution=(16, 16))
    scene = scene.with_accel()
    fwd = render(scene, camera, PathIntegrator(max_depth=4), spp=64,
                 samples_per_pass=32, n_spectrum=8, device="cpu").numpy()
    lp = lightpath.render_lightpath(scene, camera, n_paths_total=1 << 17,
                                    max_depth=4, paths_per_pass=1 << 16,
                                    n_spectrum=8, device="cpu").numpy()
    assert np.isfinite(lp).all() and (lp >= 0).all()
    assert abs(lp.mean() - fwd.mean()) < 0.12 * fwd.mean(), (lp.mean(),
                                                             fwd.mean())
    fb = fwd.reshape(4, 4, 4, 4, 3).mean(axis=(1, 3))
    lb = lp.reshape(4, 4, 4, 4, 3).mean(axis=(1, 3))
    assert np.median(np.abs(fb - lb) / np.maximum(fb, 0.05)) < 0.25


def test_lightpath_refuses_gradient():
    scene, camera = _room(8)
    scene.lights.area_scale.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        lightpath.render_lightpath(scene, camera, n_paths_total=64,
                                   paths_per_pass=64, n_spectrum=4,
                                   device="cpu")
    with torch.no_grad():
        img = lightpath.render_lightpath(scene, camera, n_paths_total=64,
                                         paths_per_pass=64, n_spectrum=4,
                                         device="cpu")
    assert bool(torch.isfinite(img).all())
