"""The port's pixel filters (pbrt_tpu_torch/filters/filters.py) against
the reference on the CPU.

- Every kind (box, triangle, gaussian, mitchell, lanczos): the signed
  32 x 32 table, its PiecewiseConstant2D (the conditional and marginal
  cdfs and integrals) and the integral ratio bit-equal to the
  reference's; `sample` (offset and sign weight) and `evaluate` bit-equal
  to the reference's jitted ones on 4,096 numpy-seeded points (XLA
  contracts uv * 2r - r to one rounding and multiplies by 1 / (2r)).
- camera_rays_full with a filter: the importance-sampled film offset
  and weight equal the reference's jitted ones.
- A kind the reference lacks raises ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.filters.filters import Filter as JaxFilter
from pbrt_tpu.render import camera_rays_full as jax_camera_rays_full
from pbrt_tpu.samplers.samplers import Sampler as JaxSampler
from pbrt_tpu.scenes.cornell import cornell_box as jax_cornell_box
from pbrt_tpu_torch.convert import filter_from_arrays
from pbrt_tpu_torch.filters.filters import DEFAULT_RADIUS, Filter
from pbrt_tpu_torch.render import camera_rays_full
from pbrt_tpu_torch.samplers.samplers import Sampler

from .torch_port_helpers import flatten_jax, port_scene_and_camera

torch.set_num_threads(2)
KINDS = sorted(DEFAULT_RADIUS)


def _bits_equal(a, b):
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                          np.asarray(b, np.float32).view(np.uint32))


@pytest.mark.parametrize("kind", KINDS)
def test_filter_matches_reference(kind):
    jf, tf = JaxFilter.create(kind), Filter.create(kind)
    assert tf.radius == jf.radius and tf.integral_ratio == jf.integral_ratio
    assert _bits_equal(jf.values, tf.values)
    for part in ("conditional", "marginal"):
        for f in ("func", "cdf", "integral"):
            assert _bits_equal(getattr(getattr(jf.dist, part), f),
                               getattr(getattr(tf.dist, part), f)), (part, f)
    u = np.random.default_rng(1).random((4096, 2)).astype(np.float32)
    js = jax.jit(jf.sample)(jnp.asarray(u))
    ts = tf.sample(torch.from_numpy(u))
    assert _bits_equal(js.p, ts.p) and _bits_equal(js.weight, ts.weight)
    p = (np.random.default_rng(2).random((4096, 2)) * 2.2 - 1.1).astype(
        np.float32) * np.float32(tf.radius[0])
    assert _bits_equal(jax.jit(jf.evaluate)(jnp.asarray(p)),
                       tf.evaluate(torch.from_numpy(p)))
    conv = filter_from_arrays(*flatten_jax(jf))
    assert _bits_equal(conv.sample(torch.from_numpy(u)).p, ts.p)
    if kind in ("box", "triangle", "gaussian"):
        assert bool((ts.weight == 1.0).all())
    else:  # negative lobes carry negative weights
        assert bool((ts.weight < 0).any())


@pytest.mark.parametrize("kind", ["gaussian", "mitchell"])
def test_camera_rays_with_filter_match_reference(kind):
    jscene, jcam = jax_cornell_box(resolution=(16, 16))
    _, tcam = port_scene_and_camera(jscene, jcam)
    pixel = np.tile(np.arange(256, dtype=np.int32), 4)
    sample = np.repeat(np.arange(4, dtype=np.int32), 256)
    js = JaxSampler.create("zsobol", spp=4, nx=16, log2_res=4)
    ts = Sampler.create("zsobol", spp=4, nx=16, log2_res=4)
    jo = jax.jit(lambda p, s: jax_camera_rays_full(
        jcam, p, s, js, filt=JaxFilter.create(kind)))(jnp.asarray(pixel),
                                                       jnp.asarray(sample))
    to = camera_rays_full(tcam, torch.from_numpy(pixel.astype(np.int64)),
                          torch.from_numpy(sample.astype(np.int64)), ts,
                          filt=Filter.create(kind), n_spectrum=32)
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), rtol=0,
                               atol=1e-6)
    assert _bits_equal(jo[3], to[3])


def test_unknown_filter_kind_raises():
    with pytest.raises(ValueError, match="unknown filter kind 'sinc'"):
        Filter.create("sinc")
