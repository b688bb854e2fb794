"""The port's backward pass against the JAX reference on the CPU: the
bench's image loss and its gradients with respect to the default trainable
set (materials.albedo_coeffs, lights.area_scale) through the remat path,
the port's own finite-difference gates, the checkpointing (equal to plain
autograd), no query in the backward pass of any estimator, and
training_step.

One jax.value_and_grad of the reference (its default grad_mode="remat",
its dense tester answering the queries on the CPU) serves every
comparison with the reference in this file. Its answer is committed
(tests/data/torch_port/reference_answers.npz, made by
scripts/make_torch_port_golden_answers.py with jax_loss_and_grads); the
fixture checks a digest of the reference's scene, camera and batch,
built live here.
"""

import numpy as np
import pytest
import torch

from pbrt_tpu.core.spectrum import N_SPECTRUM
from pbrt_tpu.scenes.cornell import cornell_box as jax_cornell_box
from pbrt_tpu_torch.accel import api as accel_api
from pbrt_tpu_torch.core.take import take
from pbrt_tpu_torch.models import path as path_mod
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.parallel.train import (
    DEFAULT_TRAINABLE,
    _get_path,
    render_loss_and_grad,
    training_step,
)
from pbrt_tpu_torch.render import camera_rays
from pbrt_tpu_torch.scenes.cornell import cornell_box

from .torch_port_helpers import (
    inputs_digest,
    port_scene_and_camera,
    reference_answers,
    tree_inputs,
)

torch.set_num_threads(2)

RES, SPP, DEPTH = 8, 2, 5
# Port against reference: each gradient entry within rtol 1e-4 plus 1e-6
# of its tensor's largest magnitude (measured: 1.1e-5 relative at most);
# the loss within rtol 1e-5.
GRAD_RTOL, GRAD_ATOL_OF_MAX, LOSS_RTOL = 1e-4, 1e-6, 1e-5


def _batch(res=RES, spp=SPP):
    npix = res * res
    pixel = np.tile(np.arange(npix, dtype=np.int32), spp)
    sample = np.repeat(np.arange(spp, dtype=np.int32), npix)
    return pixel, sample


@pytest.fixture(scope="module")
def reference():
    """The reference's bench loss and gradients (bench.py
    _cornell_fwdbwd's loss_fn) on Cornell 8x8, 2 spp, depth 5, no RR:
    jax_loss_and_grads' answer, committed, for the scene built here."""
    js, jc = reference_inputs()
    want = reference_answers("grad/cornell8", reference_digest(js, jc))
    return {
        "port": port_scene_and_camera(js, jc),
        "loss": float(want["loss"]),
        "materials.albedo_coeffs": want["albedo_coeffs"],
        "lights.area_scale": want["area_scale"],
    }


def reference_inputs():
    js, jc = jax_cornell_box(resolution=(RES, RES))
    return js.with_accel(), jc


def reference_digest(js, jc) -> str:
    pixel, sample = _batch()
    return inputs_digest(tree_inputs(js), tree_inputs(jc), dict(
        pixel=pixel, sample=sample, depth=np.asarray(DEPTH),
        n_spectrum=np.asarray(N_SPECTRUM)))


def jax_loss_and_grads(js, jc) -> dict:
    """One jax.value_and_grad of the reference's loss, jitted (its default
    grad_mode="remat", its dense tester answering the queries on the
    CPU): {"loss", "albedo_coeffs", "area_scale"}."""
    import jax
    import jax.numpy as jnp

    from pbrt_tpu.films.rgb import spectrum_to_rgb as jax_spectrum_to_rgb
    from pbrt_tpu.models.path import PathIntegrator as JPathIntegrator
    from pbrt_tpu.render import camera_rays as jax_camera_rays

    pixel, sample = _batch()
    jpix, jsam = jnp.asarray(pixel), jnp.asarray(sample)
    integ = JPathIntegrator(max_depth=DEPTH, rr_start_depth=DEPTH)
    target = jnp.full((pixel.shape[0], 3), 0.25, jnp.float32)

    def loss_fn(albedo_coeffs, area_scale):
        s = js.replace(
            materials=js.materials.replace(albedo_coeffs=albedo_coeffs),
            lights=js.lights.replace(area_scale=area_scale),
        )
        o, d, wl = jax_camera_rays(jc, jpix, jsam, jnp.int32(0))
        radiance = integ.trace(s, o, d, wl, jpix, jsam, jnp.int32(0))
        return jnp.mean((jax_spectrum_to_rgb(radiance, wl) - target) ** 2)

    loss, (ga, gs) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        js.materials.albedo_coeffs, js.lights.area_scale)
    return {"loss": np.asarray(loss), "albedo_coeffs": np.asarray(ga),
            "area_scale": np.asarray(gs)}


def _port_loss_and_grad(scene, camera, integrator=None):
    pixel, sample = _batch()
    integrator = integrator or PathIntegrator(max_depth=DEPTH,
                                              rr_start_depth=DEPTH)
    return render_loss_and_grad(
        scene, camera, integrator, torch.from_numpy(pixel).long(),
        torch.full((pixel.shape[0], 3), 0.25),
        torch.from_numpy(sample).long(), 0, n_spectrum=N_SPECTRUM,
    )


def test_loss_and_gradients_match_reference(reference):
    scene, camera = reference["port"]
    loss, grads = _port_loss_and_grad(scene, camera)
    assert set(grads) == set(DEFAULT_TRAINABLE)
    assert float(loss) == pytest.approx(reference["loss"], rel=LOSS_RTOL)
    for name in DEFAULT_TRAINABLE:
        got, want = grads[name].numpy(), reference[name]
        assert got.shape == want.shape and np.all(np.isfinite(got)), name
        np.testing.assert_allclose(
            got, want, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * np.max(np.abs(want)), err_msg=name)
    # Materials 3 and 4 (the spare rows) are hit by no ray: exactly 0 in
    # both packages.
    g_albedo = grads["materials.albedo_coeffs"].numpy()
    assert np.all(reference["materials.albedo_coeffs"][3:] == 0.0)
    assert np.all(g_albedo[3:] == 0.0)
    assert np.all(g_albedo[:3] != 0.0)
    assert np.all(grads["lights.area_scale"].numpy() > 0.0)


def _mean_image(scene, camera, integrator, spp=4, seed=0):
    """tests/test_gradients.py's loss: the mean radiance of a pass."""
    pixel, sample = (torch.from_numpy(x).long() for x in _batch(spp=spp))
    o, d, wl = camera_rays(camera, pixel, sample, seed)
    return torch.mean(integrator.trace(scene, o, d, wl, pixel, sample, seed))


def _grad_and_loss(scene, camera, integrator, member, field, theta):
    """d mean_image / d theta for scene.member.field = theta, and a
    loss(theta) for finite differences."""
    def with_theta(t):
        part = getattr(scene, member)
        return scene.replace(**{member: part.replace(**{field: t})})

    x = theta.clone().requires_grad_(True)
    g, = torch.autograd.grad(_mean_image(with_theta(x), camera, integrator), x)

    def loss(t):
        with torch.no_grad():
            return float(_mean_image(with_theta(t), camera, integrator))

    return g, loss


def test_albedo_gradient_matches_fd():
    """Central differences on the three largest finite entries (the same
    RNG stream on every evaluation), every entry finite."""
    scene, camera = cornell_box(resolution=(RES, RES))
    scene = scene.with_accel()
    integ = PathIntegrator(max_depth=3, rr_start_depth=100)
    theta = scene.materials.albedo_coeffs
    g, loss = _grad_and_loss(scene, camera, integ, "materials",
                             "albedo_coeffs", theta)
    g = g.numpy().ravel()
    assert np.all(np.isfinite(g))
    eps, rtol = 1e-2, 0.05
    for i in np.argsort(-np.abs(g))[:3]:
        tp, tm = theta.clone().reshape(-1), theta.clone().reshape(-1)
        tp[i] += eps
        tm[i] -= eps
        fd = (loss(tp.reshape(theta.shape)) - loss(tm.reshape(theta.shape))) \
            / (2 * eps)
        assert abs(fd - g[i]) <= rtol * max(abs(fd), abs(g[i]), 1e-6), \
            (i, fd, g[i])


def test_emission_gradient_matches_fd():
    """Emission is linear in scale: the gradient's sum is the forward
    difference of a uniform step."""
    scene, camera = cornell_box(resolution=(RES, RES))
    scene = scene.with_accel()
    integ = PathIntegrator(max_depth=2, rr_start_depth=100)
    theta = scene.lights.area_scale
    g, loss = _grad_and_loss(scene, camera, integ, "lights", "area_scale",
                             theta)
    g = g.numpy()
    eps = 0.1
    fd = (loss(theta + eps) - loss(theta)) / eps
    assert np.all(np.isfinite(g))
    assert abs(g.sum() - fd) <= 0.03 * max(abs(fd), 1e-6), (g.sum(), fd)
    assert (g > 0).all()


def test_checkpointed_gradients_equal_plain_autograd(reference, monkeypatch):
    scene, camera = reference["port"]
    loss, grads = _port_loss_and_grad(scene, camera)
    monkeypatch.setattr(path_mod, "_remat", path_mod._direct)
    plain_loss, plain = _port_loss_and_grad(scene, camera)
    assert torch.equal(loss, plain_loss)
    for name in DEFAULT_TRAINABLE:
        assert torch.equal(grads[name], plain[name]), name


@pytest.mark.parametrize("mode", [
    {}, {"replay_grad": False}, {"grad_mode": "cvjp"},
    {"grad_mode": "cvjp", "replay_remat": "dots"},
    {"grad_mode": "cvjp", "replay_remat": "none"},
], ids=["remat", "attached", "cvjp_full", "cvjp_dots", "cvjp_none"])
def test_backward_pass_runs_no_query(reference, monkeypatch, mode):
    """Under every estimator the forward runs the primal's queries and the
    backward none: remat recomputes shading only, cvjp replays it from
    the recorded hits, the attached estimator keeps its activations."""
    scene, camera = reference["port"]
    calls = {"closest": 0, "any_hit": 0}
    for name in calls:
        fn = getattr(accel_api, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(accel_api, name, counted)
    x = scene.materials.albedo_coeffs.clone().requires_grad_(True)
    s = scene.replace(materials=scene.materials.replace(albedo_coeffs=x))
    integ = PathIntegrator(max_depth=DEPTH, rr_start_depth=DEPTH, **mode)
    loss = _mean_image(s, camera, integ, spp=SPP)
    assert calls == {"closest": DEPTH + 1, "any_hit": DEPTH}
    loss.backward()
    assert calls == {"closest": DEPTH + 1, "any_hit": DEPTH}
    assert torch.isfinite(x.grad).all() and bool((x.grad != 0).any())


def test_training_step_is_sgd(reference):
    scene, camera = reference["port"]
    pixel, sample = (torch.from_numpy(x).long() for x in _batch())
    target = torch.full((pixel.shape[0], 3), 0.25)
    integ = PathIntegrator(max_depth=DEPTH, rr_start_depth=DEPTH)
    lr = 1e-2
    loss, grads = render_loss_and_grad(scene, camera, integ, pixel, target,
                                       sample, 0, n_spectrum=N_SPECTRUM)
    step_loss, new_scene = training_step(scene, camera, integ, pixel, target,
                                         sample, 0, lr=lr,
                                         n_spectrum=N_SPECTRUM)
    assert torch.equal(step_loss, loss)
    for name in DEFAULT_TRAINABLE:
        new = _get_path(new_scene, name)
        assert not new.requires_grad
        assert torch.equal(new, _get_path(scene, name) - lr * grads[name])
    assert torch.equal(new_scene.materials.roughness,
                       scene.materials.roughness)


@pytest.mark.parametrize("shape", [(5, 3), (2,)])
def test_take_matches_indexing(shape):
    """take's gather is table[idx], and its backward sums the rows of
    duplicate indices as indexing's does; an unused row gets exactly 0."""
    rng = np.random.default_rng(0)
    table = torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                         requires_grad=True)
    idx = torch.from_numpy(rng.integers(0, shape[0] - 1, 4096))
    w = torch.tensor(rng.normal(size=(4096, *shape[1:])), dtype=torch.float32)
    got, want = take(table, idx), table[idx]
    assert torch.equal(got, want)
    g_got, = torch.autograd.grad(torch.sum(got * w), table)
    g_want, = torch.autograd.grad(torch.sum(want * w), table)
    torch.testing.assert_close(g_got, g_want, rtol=1e-6, atol=1e-5)
    assert torch.all(g_got[-1] == 0.0)
    with torch.no_grad():
        assert torch.equal(take(table, idx), want)
