"""The port's device meshes, sharded renders and mesh training step
(pbrt_tpu_torch/parallel/mesh.py, render.py, train.py) on a CPU mesh of 8
entries, the counterpart of the reference's 8 virtual CPU devices, with
the cases of tests/test_parallel.py (but the two that run
__graft_entry__, which stays on JAX) and tests/test_multihost.py at the
reference's gates:

- the tile-sharded image is bit-equal across mesh sizes (8 and 1);
- the spp-sharded image is within rtol 2e-5 / atol 2e-6 of the
  tile-sharded one (another order of sums), and bit-equal over repeats;
- the mesh training step matches the one-device step within rtol 2e-4 /
  atol 1e-7 (gradients) and rtol 1e-5 (loss).

And against the reference's own sharded renders and mesh step
(tests/data/torch_port/parallel16.npz, scripts/
make_torch_port_golden_parallel.py: 16x16, depth 3, 8 lanes, 4 and 8
spp, on its 8-device CPU mesh): at least 99% of image values within
rtol 1e-3 / atol 1e-5 (the two pipelines' float rounding moves a few
paths), the step's loss within rtol 1e-3 and its gradients within 1e-3
of each tensor's largest entry.
"""

import os

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.parallel import make_mesh, shard_pixels, training_step
from pbrt_tpu_torch.parallel.mesh import Mesh, replicate
from pbrt_tpu_torch.parallel.render import (
    render_spp_sharded,
    render_tile_sharded,
)
from pbrt_tpu_torch.render import camera_rays
from pbrt_tpu_torch.films.rgb import spectrum_to_rgb
from pbrt_tpu_torch.scenes.cornell import cornell_box

from .torch_port_helpers import share_close

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port",
                      "parallel16.npz")
LANES = 8


@pytest.fixture(scope="module")
def setup():
    scene, camera = cornell_box(resolution=(16, 16))
    return scene.with_accel(), camera, PathIntegrator(max_depth=3)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def renders(setup, mesh8):
    """The module's sharded renders, each made once. The mesh of 8 traces
    each shard's samples in one wave, the mesh of 1 one sample a wave."""
    scene, camera, integ = setup
    kw = dict(n_spectrum=LANES)
    return {
        "tile4_mesh8": render_tile_sharded(scene, camera, integ, mesh8, spp=4,
                                           samples_per_pass=4, **kw),
        "tile4_mesh1": render_tile_sharded(
            scene, camera, integ, make_mesh(devices=["cpu"]), spp=4, **kw),
        "tile8_mesh8": render_tile_sharded(scene, camera, integ, mesh8, spp=8,
                                           samples_per_pass=8, **kw),
        "spp8_mesh8": render_spp_sharded(scene, camera, integ, mesh8, spp=8,
                                         **kw),
        "spp8_mesh8_again": render_spp_sharded(scene, camera, integ, mesh8,
                                               spp=8, **kw),
    }


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_mesh_has_8_devices(mesh8):
    assert mesh8.size == mesh8.local_size == 8
    assert all(d == torch.device("cpu") for d in mesh8.devices)
    assert make_mesh(4, devices=["cpu"] * 8).size == 4


def test_make_mesh_needs_a_card_or_named_devices():
    """The default mesh is the CUDA devices of this process: without a
    card it raises; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        assert make_mesh().devices[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError):
        make_mesh(9, devices=["cpu"] * 8)


def test_shards_are_contiguous_chunks_in_mesh_order(mesh8):
    """P("data"): contiguous, equal chunks in mesh order, each on its
    device; replicas on one device share one copy."""
    pixel = torch.arange(64)
    shards = shard_pixels(pixel, mesh8)
    assert [s.tolist() for s in shards] == [list(range(8 * i, 8 * i + 8))
                                            for i in range(8)]
    rows = shard_pixels(torch.zeros(64, 3), mesh8)
    assert all(r.shape == (8, 3) for r in rows)
    with pytest.raises(ValueError, match="evenly"):
        shard_pixels(torch.arange(60), mesh8)
    scene, camera = cornell_box(resolution=(2, 2))
    copies = replicate(scene, mesh8)
    assert len(copies) == 8 and all(c is copies[0] for c in copies)
    two = Mesh(devices=(torch.device("cpu"),) * 2, process_index=1,
               process_count=3)
    assert two.size == 6 and two.first_shard == 2
    assert [s.tolist() for s in shard_pixels(torch.arange(12), two)] == [
        [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="spans processes"):
        render_tile_sharded(scene, camera, PathIntegrator(), two, spp=1)


def test_sharded_forward_matches_single_device(setup, mesh8):
    """Tile-sharded radiance equals the unsharded one."""
    scene, camera, integ = setup
    pixel = torch.arange(16 * 16)

    def fwd(pixel):
        o, d, wl = camera_rays(camera, pixel, 0, 0, n_spectrum=LANES)
        L = integ.trace(scene, o, d, wl, pixel, 0, 0)
        return spectrum_to_rgb(L, wl)

    ref = fwd(pixel)
    out = torch.cat([fwd(p) for p in shard_pixels(pixel, mesh8)])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(out, ref)


def test_tile_sharded_matches_single(renders):
    """Bitwise across decompositions (and waves of 4 samples or 1)."""
    a, b = renders["tile4_mesh8"], renders["tile4_mesh1"]
    assert a.shape == (16, 16, 3) and bool(torch.isfinite(a).all())
    np.testing.assert_array_equal(a.numpy(), b.numpy())  # bitwise


def test_spp_sharded_matches_tile(renders):
    # The same samples, another order of sums: allclose.
    np.testing.assert_allclose(renders["spp8_mesh8"].numpy(),
                               renders["tile8_mesh8"].numpy(),
                               rtol=2e-5, atol=2e-6)


def test_bitwise_repeatability(renders):
    np.testing.assert_array_equal(renders["spp8_mesh8"].numpy(),
                                  renders["spp8_mesh8_again"].numpy())


@pytest.mark.parametrize("key,golden_key", [
    ("tile4_mesh8", "tile4"), ("tile8_mesh8", "tile8"),
    ("spp8_mesh8", "spp8")])
def test_renders_match_the_reference(renders, golden, key, golden_key):
    assert int(golden["n_spectrum"]) == LANES
    got, want = renders[key].numpy(), golden[golden_key]
    assert got.shape == want.shape
    share, n_off = share_close(got, want, rtol=1e-3, atol=1e-5)
    assert share >= 0.99, (share, n_off)
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-3)


def _step_inputs(k=2, res=16):
    npix = res * res
    pixel = torch.arange(npix).repeat(k)
    sample = torch.arange(k).repeat_interleave(npix)
    return pixel, torch.full((npix * k, 3), 0.25), sample


@pytest.fixture(scope="module")
def steps(setup, mesh8):
    scene, camera, integ = setup
    pixel, target, sample = _step_inputs()
    kw = dict(lr=1.0, n_spectrum=LANES)
    return {
        "mesh8": training_step(scene, camera, integ, pixel, target, sample,
                               0, mesh=mesh8, **kw),
        "one": training_step(scene, camera, integ, pixel, target, sample, 0,
                             **kw),
    }


LEAVES = (("albedo_coeffs", "materials"), ("area_scale", "lights"))


def _grads(scene, new_scene):
    """start - step at lr 1: the gradient the step applied."""
    return {name: (getattr(getattr(scene, part), name)
                   - getattr(getattr(new_scene, part), name)).numpy()
            for name, part in LEAVES}


def test_mesh_training_step_matches_one_device(setup, steps):
    scene = setup[0]
    (loss8, new8), (loss1, new1) = steps["mesh8"], steps["one"]
    np.testing.assert_allclose(float(loss8), float(loss1), rtol=1e-5)
    g8, g1 = _grads(scene, new8), _grads(scene, new1)
    for name in g8:
        assert np.abs(g1[name]).max() > 0, name
        np.testing.assert_allclose(g8[name], g1[name], rtol=2e-4, atol=1e-7,
                                   err_msg=name)
    # The untrained leaves are the scene's own.
    assert torch.equal(new8.materials.eta, scene.materials.eta)


def test_mesh_training_step_matches_the_reference(setup, steps, golden):
    scene = setup[0]
    loss, new = steps["mesh8"]
    np.testing.assert_allclose(float(loss), float(golden["step_loss"]),
                               rtol=1e-3)
    got = _grads(scene, new)
    for name, _ in LEAVES:
        np.testing.assert_array_equal(
            getattr(getattr(scene, dict(LEAVES)[name]), name).numpy(),
            golden[f"start_{name}"])
        want = golden[f"start_{name}"] - golden[f"step_{name}"]
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-3 * scale,
                                   err_msg=name)


def test_mesh_of_one_steps_as_one_device(setup):
    """A mesh of one entry is the one-device step up to the loss's order
    of sums (a sum over the count, not a mean)."""
    scene, camera, integ = setup
    pixel, target, sample = (x[:64] for x in _step_inputs(k=1, res=16))
    loss_m, new_m = training_step(scene, camera, integ, pixel, target, sample,
                                  mesh=make_mesh(devices=["cpu"]),
                                  n_spectrum=LANES)
    loss_1, new_1 = training_step(scene, camera, integ, pixel, target, sample,
                                  n_spectrum=LANES)
    np.testing.assert_allclose(float(loss_m), float(loss_1), rtol=1e-6)
    for name, part in LEAVES:
        np.testing.assert_allclose(
            getattr(getattr(new_m, part), name).numpy(),
            getattr(getattr(new_1, part), name).numpy(), rtol=1e-6, atol=1e-9)
