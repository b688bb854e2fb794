"""The port's participating media (pbrt_tpu_torch/media, ops/compact.py)
against the reference on the CPU.

- Tables, bit for bit: the spectrum fits of every medium kind and of the
  interior-media stack, the grid's majorant grid (max-pool and dilation)
  and global maximum, the corner table, the rgbgrid's per-voxel fits and
  wavelength-max majorant grid, the cloud's parameters, and the bench
  cloud's whole medium.
- Lookups on seeded random points and rays against the reference's eager
  JAX ops: bit-equal where the ops are plain float32 arithmetic on the
  geometry (bounds_segment, the trilinear and corner-table densities, the
  DDA cell lookups and exits); the spectra (sigma_at of every kind, the
  majorant, the stack's sigma, the grid's emission) within rtol 2e-6: the
  port's rgb2spec.eval_sigmoid divides by the wavelength range as PyTorch
  divides by a scalar, a multiply by its reciprocal, 1-3 ulp off on ~0.3%
  of values; the phase function's sampled directions, its density at
  given directions and the cloud's Perlin density within rtol 1e-5 /
  atol 1e-6 (transcendental functions, in which XLA and PyTorch may round
  the last bit otherwise). A sampled pdf is held to the density at its
  own sampled direction: near g = 0.99 the lobe is so peaked that an ulp
  of direction moves it by up to 0.7%.
- Staged compaction bit-equal to the lockstep loop: a toy walk whose
  live set stays above the reference's stage capacity, and the cloud's
  delta-tracking and ratio-tracking walks in a full trace.
- The JAX suite's semantic gates (tests/test_media.py,
  tests/test_medium_interface.py) on the port alone, at their tolerances.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.media import phase as jph
from pbrt_tpu.media.medium import MediumBuffers as JMedium
from pbrt_tpu.media.medium import MediumStack as JStack
from pbrt_tpu_torch.core import spectrum
from pbrt_tpu_torch.media import phase as ph
from pbrt_tpu_torch.media.medium import MediumBuffers, MediumStack
from pbrt_tpu_torch.ops.compact import default_stages, staged_masked_loop

from .torch_port_helpers import flatten_jax

torch.set_num_threads(2)
RNG = np.random.default_rng(12)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@functools.lru_cache(maxsize=None)
def _cloud():
    """The port's bench cloud (48^3 grid), built once per module."""
    from pbrt_tpu_torch.scenes.cloud import cloud_scene

    return cloud_scene(resolution=(12, 12))


def _same_tables(port, ref):
    want, want_static = flatten_jax(ref)
    got, got_static = flatten_jax(port)
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg=path)
    assert got_static == want_static


def _grid_density():
    return RNG.uniform(0.0, 2.0, (6, 5, 7)).astype(np.float32) * (
        RNG.uniform(size=(6, 5, 7)) > 0.3)


SA, SS = (0.3, 0.5, 0.9), (1.2, 0.7, 0.2)
LO, HI = (-1.0, 0.5, -0.8), (1.2, 2.0, 0.9)
_RGB_SA = RNG.uniform(0.0, 5.0, (4, 3, 5, 3)).astype(np.float32)
_RGB_SS = RNG.uniform(0.0, 2.0, (4, 3, 5, 3)).astype(np.float32)
_DENSITY = _grid_density()


def _media(cls):
    return {
        "none": cls.none(),
        "homogeneous": cls.homogeneous(SA, SS, LO, HI, g=0.3, scale=2.0),
        "grid": cls.grid(_DENSITY, SA, SS, LO, HI, g=-0.2, scale=3.0,
                         le_rgb=(1.0, 0.5, 0.2), le_scale=2.0, maj_res=3),
        "rgbgrid": cls.rgbgrid(_RGB_SA, _RGB_SS, LO, HI, g=0.1, scale=1.5,
                               maj_res=2),
        "cloud": cls.cloud(SA, SS, LO, HI, g=0.4, density=0.8,
                           wispiness=1.3, frequency=4.0),
    }


@pytest.fixture(scope="module")
def media():
    return _media(MediumBuffers), _media(JMedium)


@pytest.mark.parametrize("kind", ["none", "homogeneous", "grid", "rgbgrid",
                                  "cloud"])
def test_medium_tables_bit_equal(media, kind):
    port, ref = media[0][kind], media[1][kind]
    assert port.kind == ref.kind == kind
    _same_tables(port, ref)
    if kind == "grid":
        np.testing.assert_array_equal(port.corner_table().numpy(),
                                      np.asarray(ref.corner_table()))
    assert port.emissive == ref.emissive == (kind == "grid")
    assert port.is_none == ref.is_none == (kind == "none")


def test_stack_and_bench_cloud_tables_bit_equal():
    from pbrt_tpu.scenes import cloud as jax_cloud
    from pbrt_tpu_torch.scenes import cloud

    specs = [{"sigma_a": (1.0, 0.5, 0.2), "sigma_s": (0.0, 0.3, 3.0),
              "g": 0.3},
             {"sigma_a": (0.1, 0.1, 0.1), "sigma_s": (2.0, 2.0, 2.0),
              "g": -0.2, "scale": 2.0}]
    _same_tables(MediumStack.build(specs), JStack.build(specs))
    # The bench cloud's procedural density and its medium (the grid's
    # build from it is the reference's numpy, held above).
    dens = cloud._procedural_cloud()
    np.testing.assert_array_equal(dens, jax_cloud._procedural_cloud())
    want = JMedium.grid(dens, (0.15,) * 3, (1.0,) * 3, (-1.0, 0.6, -1.0),
                        (1.0, 2.6, 1.0), g=0.3, scale=8.0)
    _same_tables(_cloud()[0].medium, want)


def _points(n=4096):
    lo, hi = np.asarray(LO), np.asarray(HI)
    span = hi - lo
    p = RNG.uniform(lo - 0.2 * span, hi + 0.2 * span, (n, 3))
    # Voxel and cell faces and the box's faces, where floors and clamps
    # turn.
    p[:64, 0] = lo[0]
    p[64:128, 1] = hi[1]
    p[128:192, 2] = lo[2] + span[2] * 0.5
    return p.astype(np.float32)


def _rays(n=4096):
    o = RNG.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = RNG.normal(size=(n, 3)).astype(np.float32)
    d[:256, 1:] = 0.0  # axis-parallel rays: the 1e-12 guards
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, RNG.uniform(0.0, 6.0, n).astype(np.float32)


def _spectra_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-30)


def _lam(n):
    u = RNG.uniform(size=n).astype(np.float32)
    return spectrum.sample_visible(_t(u), 8).lam.numpy()


@pytest.mark.parametrize("kind", ["homogeneous", "grid", "rgbgrid", "cloud"])
def test_medium_lookups_match_reference(media, kind):
    port, ref = media[0][kind], media[1][kind]
    p = _points()
    o, d, tmax = _rays()
    lam = _lam(p.shape[0])
    if kind == "homogeneous":  # one code path for every kind
        for got, want in zip(port.bounds_segment(_t(o), _t(d), _t(tmax)),
                             ref.bounds_segment(jnp.asarray(o), jnp.asarray(d),
                                                jnp.asarray(tmax))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(port.sigma_at(_t(p), _t(lam)),
                         ref.sigma_at(jnp.asarray(p), jnp.asarray(lam))):
        if kind != "cloud":
            _spectra_close(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
    _spectra_close(port.sigma_majorant(_t(lam)),
                   ref.sigma_majorant(jnp.asarray(lam)))
    if kind == "cloud":
        got = port._cloud_density(_t(p)).numpy()
        want = np.asarray(ref._cloud_density(jnp.asarray(p)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert 0.01 < got.std() and got.min() >= 0.0 and got.max() <= 1.0
    if kind == "grid":  # rgbgrid's DDA runs the same code on its grid
        base = RNG.uniform(0.1, 3.0, p.shape[0]).astype(np.float32)
        np.testing.assert_array_equal(
            port.majorant_local(_t(p), _t(base)).numpy(),
            np.asarray(ref.majorant_local(jnp.asarray(p), jnp.asarray(base))))
        np.testing.assert_array_equal(
            port.cell_exit_t(_t(o), _t(d), _t(tmax)).numpy(),
            np.asarray(ref.cell_exit_t(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(tmax))))
    if kind == "grid":
        np.testing.assert_array_equal(
            port._trilinear(port.density, _t(p)).numpy(),
            np.asarray(ref._trilinear(ref.density, jnp.asarray(p))))
        np.testing.assert_array_equal(
            port.density_at_fast(_t(p), port.corner_table()).numpy(),
            np.asarray(ref.density_at_fast(jnp.asarray(p),
                                           ref.corner_table())))
        _spectra_close(port.le_at(_t(p), _t(lam)),
                       ref.le_at(jnp.asarray(p), jnp.asarray(lam)))


def test_stack_lookup_matches_reference():
    specs = [{"sigma_a": (1.0, 1.0, 1.0), "sigma_s": (0.0, 0.0, 0.0),
              "g": 0.3},
             {"sigma_a": (0.0, 0.0, 0.0), "sigma_s": (2.0, 2.0, 2.0),
              "g": -0.2, "scale": 2.0}]
    port, ref = MediumStack.build(specs), JStack.build(specs)
    idx = RNG.integers(-1, 2, 512).astype(np.int32)
    lam = _lam(512)
    for got, want in zip(port.sigma_at_idx(_t(idx), _t(lam)),
                         ref.sigma_at_idx(jnp.asarray(idx), jnp.asarray(lam))):
        _spectra_close(got, want)
    np.testing.assert_array_equal(port.g_at(_t(idx)).numpy(),
                                  np.asarray(ref.g_at(jnp.asarray(idx))))
    # tests/test_medium_interface.py's gate: scale applied, vacuum zero.
    sa, ss = port.sigma_at_idx(torch.tensor([0, 1, -1]),
                               torch.full((3, 4), 550.0))
    assert abs(float(sa[0, 0]) - 1.0) < 0.05 and float(ss[0, 0]) < 1e-6
    assert abs(float(ss[1, 0]) - 4.0) < 0.2
    assert float(sa[2].max()) == 0.0 and float(ss[2].max()) == 0.0


@pytest.mark.parametrize("g", [-0.6, 0.0, 5e-4, 0.3, 0.995])
def test_phase_function_matches_reference(g):
    n = 4096
    wo = RNG.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    u2 = RNG.uniform(size=(n, 2)).astype(np.float32)
    wi, pdf = ph.hg_sample(_t(wo), _t(u2), g)
    jwi, jpdf = jph.hg_sample(jnp.asarray(wo), jnp.asarray(u2), g)
    np.testing.assert_allclose(wi.numpy(), np.asarray(jwi), rtol=1e-5,
                               atol=2e-6)
    assert torch.equal(pdf, ph.hg_pdf(_t(wo), wi, g))
    wi2 = np.asarray(jwi)
    np.testing.assert_allclose(
        ph.hg_pdf(_t(wo), _t(wi2), g).numpy(),
        np.asarray(jph.hg_pdf(jnp.asarray(wo), jnp.asarray(wi2), g)),
        rtol=1e-5, atol=1e-6)
    # Per-ray g (the integrator's g_eff) broadcasts as a scalar g does.
    gv = torch.full((n,), g)
    assert torch.equal(ph.hg_sample(_t(wo), _t(u2), gv)[0], wi)


def test_phase_function_normalises():
    """tests/test_media.py's gates: sampled pdf = evaluated pdf, mean
    cosine toward -wo equals g, the density integrates to one."""
    n = 100_000
    wo = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3)
    u2 = torch.from_numpy(RNG.uniform(size=(n, 2)).astype(np.float32))
    for g in (-0.5, 0.0, 0.6):
        wi, pdf = ph.hg_sample(wo, u2, g)
        np.testing.assert_allclose(pdf.numpy(), ph.hg_pdf(wo, wi, g).numpy(),
                                   rtol=1e-4)
        assert abs(float(torch.sum(wi * -wo, dim=-1).mean()) - g) < 0.01
    nt, nphi = 256, 64
    theta = (np.arange(nt) + 0.5) / nt * np.pi
    phi = (np.arange(nphi) + 0.5) / nphi * 2 * np.pi
    tg, pg = np.meshgrid(theta, phi, indexing="ij")
    wi = torch.tensor(np.stack([np.sin(tg) * np.cos(pg),
                                np.sin(tg) * np.sin(pg), np.cos(tg)],
                               -1).reshape(-1, 3), dtype=torch.float32)
    wo = torch.tensor([[0.0, 0.0, 1.0]]).expand(wi.shape[0], 3)
    for g in (-0.7, 0.0, 0.4):
        p = ph.hg_pdf(wo, wi, g).numpy().reshape(nt, nphi)
        integral = (p * np.sin(tg)).sum() * (np.pi / nt) * (2 * np.pi / nphi)
        assert abs(integral - 1.0) < 0.01, (g, integral)


def _toy_walk(n, hold):
    """A masked walk: lane i steps until its hashed counter passes a
    per-lane threshold; `hold` of the lanes walk every step (so a stage
    boundary finds more lanes live than the reference's stage holds)."""
    from pbrt_tpu_torch.samplers.samplers import Sampler

    sampler = Sampler(seed=3)
    pixel = torch.arange(n)
    inputs = {"pixel": pixel, "sidx": torch.zeros(n, dtype=torch.int64)}

    def body(inp, it, st, u):
        live = st["acc"] < st["limit"]
        acc = torch.where(live, st["acc"] + u * u + 0.01 * it, st["acc"])
        return {"acc": acc, "limit": st["limit"],
                "steps": st["steps"] + live.to(torch.int32)}

    def draws(inp, it0, m):
        return sampler.get_1d_run(inp["pixel"], inp["sidx"], 40 + it0, m)

    state = {"acc": torch.zeros(n), "steps": torch.zeros(n, dtype=torch.int32),
             "limit": torch.where(pixel < hold, 1e9, torch.rand(
                 n, generator=torch.Generator().manual_seed(5)) * 0.9)}
    return body, inputs, state, draws


def test_staged_compaction_bit_equal_to_lockstep():
    n, steps = 1000, 48
    # The reference's stages hold max(256, n / 2) = 500 lanes in the
    # second stage; 900 lanes are still live there.
    assert default_stages(steps) == [(1, 6), (2, 9), (4, 12), (16, 21)]
    body, inputs, state, draws = _toy_walk(n, hold=900)

    def mask(st):
        return st["acc"] < st["limit"]

    out = {}
    for compact in (True, False):
        out[compact] = staged_masked_loop(body, inputs, dict(state), mask,
                                          steps, draws=draws, compact=compact)
    assert int(mask(out[False]).sum()) == 900  # the held lanes walk on
    for key in ("acc", "steps"):
        assert torch.equal(out[True][key], out[False][key]), key
    # One get_1d per step gives the same numbers as the batched draws.
    from pbrt_tpu_torch.samplers.samplers import Sampler

    s = Sampler(seed=3)
    runs = s.get_1d_run(inputs["pixel"], inputs["sidx"], 40, 12)
    for j in range(12):
        assert torch.equal(runs[:, j], s.get_1d(inputs["pixel"], 0, 40 + j))


def test_cloud_walks_compacted_equal_lockstep():
    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.render import camera_rays_full

    scene, camera = _cloud()
    pixel = torch.arange(144).repeat(2)
    sample = torch.arange(2).repeat_interleave(144)
    o, d, wl, _ = camera_rays_full(camera, pixel, sample, 0, n_spectrum=8)
    args = (scene, o, d, wl, pixel, sample, 0)
    staged = VolPathIntegrator(max_depth=2).trace_with_stats(*args)
    lockstep = VolPathIntegrator(max_depth=2,
                                 compact_walks=False).trace_with_stats(*args)
    assert torch.equal(staged[0], lockstep[0])
    assert float(staged[1]["rays"]) == float(lockstep[1]["rays"])
    assert float(staged[0].mean()) > 0.05


# --- the reference suite's semantic gates, on the port alone ---------------


def _fog_box_mean(sa, ss, max_depth, spp, use_nee=True, seed=0):
    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.render import camera_rays
    from pbrt_tpu_torch.scenes.cloud import fog_box_scene

    scene, camera = fog_box_scene(sigma_a=sa, sigma_s=ss, le_scale=5.0)
    pixel = torch.arange(64).repeat(spp)
    sample = torch.arange(spp).repeat_interleave(64)
    o, d, wl = camera_rays(camera, pixel, sample, seed, n_spectrum=8)
    integ = VolPathIntegrator(max_depth=max_depth, rr_start_depth=100,
                              use_nee=use_nee)
    return float(integ.trace(scene, o, d, wl, pixel, sample, seed).mean())


def test_beer_lambert_homogeneous():
    """tests/test_media.py::test_beer_lambert_homogeneous on the port."""
    expected = 5.0 * np.exp(-1.0)
    got = _fog_box_mean(1.0, 0.0, 3, 32, use_nee=False)
    assert abs(got - expected) / expected < 0.06, (got, expected)
    got_t = _fog_box_mean(0.5, 0.5, 1, 32, use_nee=False)
    assert expected < got_t < min(5.0, expected * 1.5), got_t
    got_s = _fog_box_mean(0.5, 0.5, 4, 32, use_nee=False)
    assert expected < got_s < 5.0, got_s
    # With NEE, scattering keeps more energy than absorbing, below the
    # unoccluded source.
    l_abs = _fog_box_mean(1.0, 0.0, 6, 16, seed=1)
    l_scat = _fog_box_mean(0.0, 1.0, 6, 16, seed=1)
    assert l_abs * 1.3 < l_scat < 5.0 * 1.02, (l_abs, l_scat)


def _slab_transmittance(use_dda, budget, sigma=60.0):
    """tests/test_media.py's slab: an empty corridor [0, 0.9) then a dense
    slab [0.9, 1) along x; the walk's mean transmittance and the slab's
    analytic one."""
    from pbrt_tpu_torch.lights.buffers import LightBuffers
    from pbrt_tpu_torch.materials.buffers import MaterialBuffers
    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.samplers.samplers import as_sampler
    from pbrt_tpu_torch.scene import Scene
    from pbrt_tpu_torch.shapes.geometry import GeometryBuffers

    dens = np.zeros((4, 4, 64), np.float32)
    dens[:, :, int(0.9 * 64):] = 1.0
    med = MediumBuffers.grid(dens, (sigma,) * 3, (0, 0, 0), (0, 0, 0),
                             (1, 1, 1), maj_res=8)
    scene = Scene(geom=GeometryBuffers.build(),
                  materials=MaterialBuffers.build([{"kind": 0}]),
                  lights=LightBuffers.build(), medium=med)
    n = 64
    o = torch.tensor([[-0.001, 0.5, 0.5]]).repeat(n, 1)
    d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1)
    wl = spectrum.sample_visible(torch.full((n,), 0.4), 8)
    integ = VolPathIntegrator(max_tr_steps=budget, use_dda=use_dda)
    tr = integ._transmittance(scene, o, d, torch.full((n,), 1.5), wl.lam,
                              torch.arange(n), torch.zeros(n, dtype=torch.int64),
                              as_sampler(7), 100)
    sa, _ = med.sigma_base(wl.lam)
    return float(tr.mean()), float(torch.exp(-sa * 0.1).mean()), med


def test_dda_skips_empty_space_where_global_truncates():
    """tests/test_media.py's DDA gates: the corridor's cells have majorant
    0, the slab's > 0; with 24 steps the DDA walk reaches the slab and
    recovers Beer-Lambert, the global walk does not."""
    got_dda, want, med = _slab_transmittance(True, 24)
    got_glob, _, _ = _slab_transmittance(False, 24)
    m = med.majorant_local(torch.tensor([[0.3, 0.5, 0.5], [0.97, 0.5, 0.5],
                                         [2.0, 0.5, 0.5]]), torch.ones(3))
    assert float(m[0]) < 1e-6 * float(m[1]) and float(m[1]) > 0.5
    assert float(m[2]) == 0.0
    te = float(med.cell_exit_t(torch.tensor([[-0.5, 0.5, 0.5]]),
                               torch.tensor([[1.0, 0.0, 0.0]]),
                               torch.tensor([0.6]))[0])
    assert 0.6 < te < 1.6
    assert abs(got_dda - want) < 0.05, (got_dda, want)
    assert got_glob > want + 0.3, (got_glob, want)


def test_dda_consistent_with_global_on_cloud():
    """At a generous budget both walks estimate the same cloud image."""
    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.render import render

    scene, camera = _cloud()
    kw = dict(spp=8, samples_per_pass=8, n_spectrum=8, device="cpu")
    a = render(scene, camera, VolPathIntegrator(max_depth=3), seed=3, **kw)
    b = render(scene, camera, VolPathIntegrator(max_depth=3, use_dda=False),
               seed=4, **kw)
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    ma, mb = float(a.mean()), float(b.mean())
    assert abs(ma - mb) < 0.1 * max(ma, mb), (ma, mb)


def test_rgbgrid_matches_homogeneous_fit():
    """tests/test_media.py's rgbgrid gates: a constant-RGB grid gives the
    homogeneous fit's sigma inside, zero outside, a conservative
    majorant, and chromatic Beer-Lambert through delta tracking."""
    from pbrt_tpu_torch.films.rgb import spectrum_to_rgb
    from pbrt_tpu_torch.lights.buffers import LightBuffers
    from pbrt_tpu_torch.materials.buffers import MaterialBuffers
    from pbrt_tpu_torch.models.volpath import VolPathIntegrator
    from pbrt_tpu_torch.samplers.samplers import as_sampler
    from pbrt_tpu_torch.scene import Scene
    from pbrt_tpu_torch.shapes.geometry import GeometryBuffers

    rgb_a = (5.0, 1.0, 0.2)
    med = MediumBuffers.rgbgrid(
        np.broadcast_to(np.asarray(rgb_a, np.float32), (8, 8, 8, 3)),
        np.zeros((8, 8, 8, 3), np.float32), (0, 0, 0), (1, 1, 1))
    hom = MediumBuffers.homogeneous(rgb_a, (0, 0, 0), (0, 0, 0), (1, 1, 1))
    lam = spectrum.sample_visible(torch.full((4,), 0.3), 8).lam
    p = torch.tensor([[0.5, 0.5, 0.5], [0.25, 0.5, 0.75], [0.5, 0.25, 0.25],
                      [0.9, 0.9, 0.9]])
    sa_r, ss_r = med.sigma_at(p, lam)
    sa_h, _ = hom.sigma_base(lam)
    np.testing.assert_allclose(sa_r.numpy(), sa_h.expand(4, -1).numpy(),
                               rtol=0.05, atol=0.05)
    np.testing.assert_allclose(ss_r.numpy(), 0.0, atol=1e-5)
    assert float(med.max_density) >= float(sa_r.max()) - 1e-4
    sa_o, _ = med.sigma_at(torch.tensor([[2.0, 0.5, 0.5]]), lam[:1])
    np.testing.assert_allclose(sa_o.numpy(), 0.0, atol=1e-6)

    rgb_a = (8.0, 2.0, 0.2)
    med = MediumBuffers.rgbgrid(
        np.broadcast_to(np.asarray(rgb_a, np.float32), (4, 4, 4, 3)),
        np.zeros((4, 4, 4, 3), np.float32), (0, 0, 0), (1, 1, 1))
    scene = Scene(geom=GeometryBuffers.build(),
                  materials=MaterialBuffers.build([{"kind": 0}]),
                  lights=LightBuffers.build(), medium=med)
    n = 512
    wl = spectrum.sample_visible((torch.arange(n) + 0.5) / n, 8)
    tr = VolPathIntegrator(max_tr_steps=96)._transmittance(
        scene, torch.tensor([[-0.5, 0.5, 0.5]]).repeat(n, 1),
        torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1), torch.full((n,), 5.0),
        wl.lam, torch.arange(n), torch.zeros(n, dtype=torch.int64),
        as_sampler(11), 50)
    got = spectrum_to_rgb(tr, wl).mean(0).numpy()
    sa_c, _ = med.sigma_at(torch.tensor([[0.5, 0.5, 0.5]]).repeat(n, 1),
                           wl.lam)
    want = spectrum_to_rgb(torch.exp(-sa_c), wl).mean(0).numpy()
    np.testing.assert_allclose(got, want, atol=0.05)
    assert got[2] > got[0] + 0.2
