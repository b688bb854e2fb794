"""Motion in the port against the JAX reference on the CPU: quaternions,
AnimatedTransform (its host decomposition and its per-time recompose),
the moving instances' pass (animated_best / animated_any), the parser's
moving ObjectInstances, a moving camera, and the moving instanced field
(tests/data/torch_port/motion.pbrt) against its JAX per-sample golden
(scripts/make_torch_port_golden_shapes.py) and its gradients against
the JAX gradient golden.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.accel import instances as jinst
from pbrt_tpu.core import quaternion as jq
from pbrt_tpu.core.transform import AnimatedTransform as JAnimatedTransform
from pbrt_tpu.core.transform import Transform as JTransform
from pbrt_tpu.io.parser import load_pbrt as jax_load_pbrt
from pbrt_tpu.render import camera_rays_full as jax_camera_rays
from pbrt_tpu.scenes.cornell import cornell_box as jax_cornell_box
from pbrt_tpu_torch.accel import instances
from pbrt_tpu_torch.convert import scene_from_arrays
from pbrt_tpu_torch.core import quaternion as q
from pbrt_tpu_torch.core.transform import AnimatedTransform
from pbrt_tpu_torch.io.parser import load_pbrt
from pbrt_tpu_torch.render import camera_rays_full

from .test_torch_parser import _assert_same_build
from .torch_port_helpers import (
    assert_samples_match,
    flatten_jax,
    port_scene_and_camera,
)
from .torch_port_shapes import DATA, MOTION_PBRT

torch.set_num_threads(2)
RTOL = 1e-5


def _rotations(rng, n):
    """Random rotations, with ones near 180 degrees about each axis (the
    diagonal-dominant Shepperd branches)."""
    axes = rng.normal(size=(n, 3))
    angles = rng.uniform(-np.pi, np.pi, n)
    angles[: n // 4] = np.pi - 1e-3
    axes[: n // 4] = np.eye(3)[rng.integers(0, 3, n // 4)] + 0.01 * axes[: n // 4]
    return np.asarray(q.quat_to_matrix(q.quat_from_axis_angle(
        torch.from_numpy(axes).float(), torch.from_numpy(angles).float())))


def test_quaternions_match_jax():
    rng = np.random.default_rng(0)
    m = _rotations(rng, 64).astype(np.float32)
    got = q.quat_from_matrix(torch.from_numpy(m))
    want = np.asarray(jq.quat_from_matrix(jnp.asarray(m)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(q.quat_to_matrix(got).numpy(),
                               np.asarray(jq.quat_to_matrix(jnp.asarray(want))),
                               atol=1e-6)
    a, b = got[:32], got[32:]
    b[:8] = a[:8] + 1e-4  # near-parallel pairs: the lerp branch
    b = q.quat_normalize(b)
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(
            q.slerp(a, b, t).numpy(),
            np.asarray(jq.slerp(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                                t)), atol=1e-6)
    np.testing.assert_allclose(
        q.quat_mul(a, b).numpy(),
        np.asarray(jq.quat_mul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))),
        atol=1e-6)


def _keyframes(rng):
    """A TRS start and end matrix with a shear-free non-uniform scale."""
    out = []
    for _ in range(2):
        r = _rotations(rng, 1)[0]
        m = np.eye(4)
        m[:3, :3] = r @ np.diag(rng.uniform(0.5, 2.0, 3))
        m[:3, 3] = rng.normal(size=3)
        out.append(m.astype(np.float32))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_animated_transform_matches_jax(seed):
    """The decomposition and the recompose at t = 0, 0.5 and 1 (and
    clamped outside the interval) within rtol 1e-5 (the parser's
    keyframes decompose bit for bit: test_parser_moving_instances)."""
    rng = np.random.default_rng(seed)
    m0, m1 = _keyframes(rng)
    ja = JAnimatedTransform.build(JTransform.from_matrix(m0),
                                  JTransform.from_matrix(m1), 0.0, 2.0)
    pa = AnimatedTransform.build(m0, m1, 0.0, 2.0)
    for k in ("t_start", "t_end", "s_start", "s_end", "q_start", "q_end"):
        np.testing.assert_allclose(getattr(pa, k).numpy(),
                                   np.asarray(getattr(ja, k)), rtol=RTOL,
                                   atol=1e-6, err_msg=k)
    times = np.asarray([0.0, 1.0, 2.0, -1.0, 3.0], np.float32)
    lin, tr = pa.interpolate_matrices(torch.from_numpy(times))
    jlin, jtr = jax.jit(ja.interpolate_matrices)(jnp.asarray(times))
    np.testing.assert_allclose(lin.numpy(), np.asarray(jlin), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jtr), rtol=RTOL,
                               atol=1e-6)
    # The keyframes themselves come back at the ends.
    np.testing.assert_allclose(lin[0].numpy(), m0[:3, :3], atol=1e-5)
    np.testing.assert_allclose(lin[2].numpy(), m1[:3, :3], atol=1e-5)


@pytest.fixture(scope="module")
def motion():
    return jax_load_pbrt(MOTION_PBRT), load_pbrt(MOTION_PBRT, device="cpu")


def test_parser_moving_instances(motion):
    """Six static instances (and the root geometry) go to the sweep, the
    two moving ones to the animated pass, as in the reference; the
    converted reference scene is the port's."""
    jax_built, port = motion
    _assert_same_build(jax_built, port)
    scene = port[0]
    assert scene.sweep.n_instances == 7 and scene.anim.ranges == ((4, 12),) * 2
    assert (scene.anim.time0, scene.anim.time1) == (0.0, 1.0)
    conv = scene_from_arrays(*flatten_jax(jax_built[0]))
    for k in ("t_start", "t_end", "q_start", "q_end", "s_start", "s_end"):
        assert torch.equal(getattr(conv.anim.xforms, k),
                           getattr(scene.anim.xforms, k)), k
    assert conv.anim.ranges == scene.anim.ranges


def test_animated_pass_matches_jax(motion):
    """animated_best and animated_any at per-ray times against the
    reference's: the same prims, t within rtol 1e-5, the normals within
    1e-5; None takes the shutter midpoint."""
    (js, _, _), (ps, _, _) = motion
    rng = np.random.default_rng(4)
    n = 2048
    tgt = rng.uniform([-1.2, 0.0, 0.5], [1.2, 0.6, 1.3], (n, 3))
    o = rng.uniform([-2, 0.2, 2], [2, 2.5, 4], (n, 3))
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    time = rng.uniform(size=n).astype(np.float32)
    t_cur = np.where(rng.uniform(size=n) < 0.2, 2.0, np.inf).astype(np.float32)
    for tm in (time, None):
        want = jax.jit(lambda o, d, t, tm: jinst.animated_best(
            js.anim, js.geom, o, d, t, tm))(
                jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_cur),
                None if tm is None else jnp.asarray(tm))
        got = instances.animated_best(
            ps.anim, ps.geom, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_cur), None if tm is None else torch.from_numpy(tm))
        prim = np.asarray(want[1])
        np.testing.assert_array_equal(got[1].numpy(), prim)
        hit = prim >= 0
        assert hit.sum() > 200
        np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(want[0])[hit],
                                   rtol=RTOL)
        np.testing.assert_allclose(got[4].numpy()[hit], np.asarray(want[4])[hit],
                                   atol=1e-5)
        np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    occ = instances.animated_any(ps.anim, ps.geom, torch.from_numpy(o),
                                 torch.from_numpy(d), torch.from_numpy(t_cur),
                                 torch.from_numpy(time))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jinst.animated_any(
        js.anim, js.geom, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_cur),
        jnp.asarray(time))))


def test_moving_camera_matches_jax():
    """A camera with motion (an AnimatedTransform over the shutter)
    converts, and its rays at the dim-5 shutter times match."""
    js, jc = jax_cornell_box(resolution=(8, 8))
    m0 = np.asarray(jc.camera_to_world.m)
    m1 = m0.copy()
    m1[:3, 3] += [0.2, 0.1, 0.0]
    jc = jc.replace(motion=JAnimatedTransform.build(
        JTransform.from_matrix(m0), JTransform.from_matrix(m1)))
    _, pc = port_scene_and_camera(js, jc)
    assert pc.motion is not None
    pixel = np.arange(64, dtype=np.int32)
    o, d, _, _ = jax.jit(lambda p: jax_camera_rays(jc, p, 0, 0))(
        jnp.asarray(pixel))
    po, pd, _, _ = camera_rays_full(pc, torch.from_numpy(pixel).long(), 0, 0,
                                    n_spectrum=8)
    np.testing.assert_allclose(po.numpy(), np.asarray(o), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(pd.numpy(), np.asarray(d), rtol=RTOL, atol=1e-6)
    still = camera_rays_full(pc.replace(motion=None),
                             torch.from_numpy(pixel).long(), 0, 0,
                             n_spectrum=8)[0]
    assert not torch.allclose(still, po)


def test_samples_match_jax(motion):
    """One pass at 16x16, 2 spp, depth 5 (K3's twin for the static
    instances, the animated pass, the alpha-cut fences) against the
    reference's per-sample radiance: the same ray count and >= 99% of the
    values within rtol 1e-3 / atol 1e-5 (all of them agree today)."""
    _, (scene, camera, settings) = motion
    golden = np.load(f"{DATA}/motion16_samples.npz")
    res, spp = int(golden["resolution"]), int(golden["spp"])
    npix = res * res
    pixel = torch.arange(npix).repeat(spp)
    sample = torch.arange(spp).repeat_interleave(npix)
    o, d, wl, _ = camera_rays_full(camera.replace(resolution=(res, res)),
                                   pixel, sample, 0, n_spectrum=8)
    with torch.no_grad():
        L, stats = settings["integrator"].trace_with_stats(
            scene, o, d, wl, pixel, sample, 0)
    assert_samples_match(golden["radiance"], float(golden["rays"]), L.numpy(),
                         float(stats["rays"]), share=0.99)


def test_gradient_matches_jax(motion):
    """chip_smoke.py g7's loss and gradients (materials.albedo_coeffs,
    lights.area_scale; 32x32, 4 spp in passes of 2, depth 5 without
    Russian roulette, 8 lanes) on the CPU against the JAX golden
    motion32_grad.npz: within 1e-3 of each tensor's largest entry."""
    import chip_smoke as cs

    _, (scene, camera, _) = motion
    z = np.load(f"{DATA}/motion32_grad.npz")
    k = int(z["samples_per_pass"])
    loss, grads = cs.grad_passes(scene, camera, int(z["resolution"]), k,
                                 int(z["n_spectrum"]), int(z["spp"]) // k,
                                 int(z["max_depth"]))
    out = cs._grad_compare(loss, grads, float(z["loss"]), {
        "materials.albedo_coeffs": z["grad_albedo_coeffs"],
        "lights.area_scale": z["grad_area_scale"]})
    assert out["ok"], out
