"""Diffuse BxDF and area-light queries of the port against the reference,
on the same converted Cornell scene and the same numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import spectrum as jspec
from pbrt_tpu.materials import bxdf as jbxdf
from pbrt_tpu.scenes.cornell import cornell_box as jax_cornell_box
from pbrt_tpu.shapes.geometry import Interaction as JInteraction
from pbrt_tpu_torch.core import spectrum
from pbrt_tpu_torch.materials import bxdf
from pbrt_tpu_torch.shapes.geometry import Interaction

from .torch_port_helpers import port_scene_and_camera

torch.set_num_threads(2)
N = 2048
S = jspec.N_SPECTRUM


@pytest.fixture(scope="module")
def scenes():
    js, jc = jax_cornell_box(resolution=(8, 8))
    js = js.with_accel()
    ps, _ = port_scene_and_camera(js, jc)
    return js, ps


def _inputs(seed):
    r = np.random.default_rng(seed)

    def unit(n):
        v = r.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    return {
        "wo": unit(N), "wi": unit(N),
        "u2": r.uniform(0, 1, (N, 2)).astype(np.float32),
        "uc": r.uniform(0, 1, N).astype(np.float32),
        "u_wl": r.uniform(0, 1, N).astype(np.float32),
        "mat": r.integers(0, 3, N).astype(np.int32),  # the diffuse rows
        "p": r.uniform(0.02, 0.98, (N, 3)).astype(np.float32),
        "n": unit(N),
        "light": r.integers(-1, 2, N).astype(np.int32),
        "t": r.uniform(0.05, 2.0, N).astype(np.float32),
    }


def _isects(x):
    kw = dict(valid=np.ones(N, bool), t=x["t"], p=x["p"], n=x["n"],
              uv=np.zeros((N, 2), np.float32), wo=x["wo"], mat=x["mat"],
              light=x["light"], prim=np.zeros(N, np.int32),
              dpdu=np.zeros((N, 3), np.float32))
    return (JInteraction(**{k: jnp.asarray(v) for k, v in kw.items()}),
            Interaction(**{k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in kw.items()}))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_diffuse_bxdf_matches(scenes):
    js, ps = scenes
    x = _inputs(0)
    ji, pi = _isects(x)
    jwl = jspec.sample_visible(jnp.asarray(x["u_wl"]))
    pwl = spectrum.sample_visible(torch.from_numpy(x["u_wl"]), S)
    jp = jbxdf.surface_params(js, ji, jwl.lam)
    pp = bxdf.surface_params(ps, pi, pwl.lam)
    jwo, jwi = jnp.asarray(x["wo"]), jnp.asarray(x["wi"])
    pwo, pwi = torch.from_numpy(x["wo"]), torch.from_numpy(x["wi"])
    _close(bxdf.evaluate(pp, pwo, pwi, pwl.lam), jbxdf.evaluate(jp, jwo, jwi, jwl.lam))
    _close(bxdf.pdf(pp, pwo, pwi), jbxdf.pdf(jp, jwo, jwi))
    pu2, juc = torch.from_numpy(x["u2"]), jnp.asarray(x["uc"])
    got = bxdf.sample(pp, pwo, pwl.lam, pu2, torch.from_numpy(x["uc"]))
    want = jbxdf.sample(jp, jwo, jwl.lam, jnp.asarray(x["u2"]), juc)
    # Sampled directions go through cos/sin: compared at the warp's 1e-6.
    _close(got["wi"], want["wi"], rtol=0, atol=2e-6)
    _close(got["f"], want["f"])
    _close(got["pdf"], want["pdf"], rtol=1e-5, atol=2e-6)
    np.testing.assert_array_equal(got["specular"].numpy(), np.asarray(want["specular"]))


def test_area_light_queries_match(scenes):
    js, ps = scenes
    x = _inputs(1)
    jwl = jspec.sample_visible(jnp.asarray(x["u_wl"]))
    pwl = spectrum.sample_visible(torch.from_numpy(x["u_wl"]), S)
    jl, pl = js.lights, ps.lights
    p, n = x["p"], x["n"]
    got = pl.sample_li(torch.from_numpy(p), pwl.lam, torch.from_numpy(x["uc"]),
                       torch.from_numpy(x["u2"]), n_ref=torch.from_numpy(n))
    want = jl.sample_li(jnp.asarray(p), jwl.lam, jnp.asarray(x["uc"]),
                        jnp.asarray(x["u2"]), n_ref=jnp.asarray(n))
    for k in ("L", "wi", "pdf", "dist"):
        _close(getattr(got, k), getattr(want, k))
    np.testing.assert_array_equal(got.is_delta.numpy(), np.asarray(want.is_delta))

    light = torch.from_numpy(x["light"])
    cos_l = torch.from_numpy((x["n"] * x["wo"]).sum(-1))
    _close(pl.pdf_li_area(light, torch.from_numpy(x["t"]), cos_l),
           jl.pdf_li_area(jnp.asarray(x["light"]), jnp.asarray(x["t"]),
                          jnp.asarray(cos_l.numpy())))
    _close(pl.emitted(light, torch.from_numpy(n), torch.from_numpy(x["wo"]), pwl.lam),
           jl.emitted(jnp.asarray(x["light"]), jnp.asarray(n), jnp.asarray(x["wo"]),
                      jwl.lam))
    d = torch.from_numpy(x["wi"])
    _close(pl.escaped_radiance(d, pwl.lam), jl.escaped_radiance(jnp.asarray(x["wi"]), jwl.lam))
    _close(pl.pdf_escaped(d), jl.pdf_escaped(jnp.asarray(x["wi"])))
