"""The port's samplers (pbrt_tpu_torch/samplers/) against the reference on
the CPU, bit for bit.

- Every kind (independent, stratified, sobol, zsobol, halton, padded,
  pmj02bn) under two settings (a 32 x 32 image at 16 spp; a flat pixel
  id at 12 spp with seed 7): get_1d and both components of get_2d at
  dimensions 0-40 on 4,096 lanes equal the reference's jitted draws,
  committed by scripts/make_torch_port_golden_cameras.py as sha256
  digests of each draw's bits (and the first 64 lanes whole).
- get_1d_run's column j equals get_1d(dim0 + j) for every kind.
- sobol_bits (four byte-table lookups) equals the reference's 32-step
  loop for every dimension row; the pmj02 tables and blue noise equal
  the reference's files, and regenerate.
- The kinds' integer steps keep 32 bits: the shuffled index's (s + h) %
  spp wraps, ZSobol's digit above bit 31 hashes zero.
"""

import os

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.samplers import pmj02, sobol
from pbrt_tpu_torch.samplers.samplers import Sampler

from . import torch_port_cameras as C

torch.set_num_threads(2)
_GOLDEN = np.load(C.SAMPLER_GOLDEN)
REF_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pbrt_tpu", "samplers", "data")


def _port_draws(kind, cfg_name, n=C.DRAW_LANES):
    cfg = C.SAMPLER_CFGS[cfg_name]
    pixel, sample = (torch.from_numpy(a.astype(np.int64))
                     for a in C.draw_lanes(n, cfg))
    s = Sampler.create(kind, spp=cfg["spp"], seed=cfg["seed"], nx=cfg["nx"],
                       log2_res=cfg["log2_res"])
    return s, pixel, sample, [v.numpy() for v in C.draws(s, pixel, sample)]


@pytest.mark.parametrize("cfg_name", ["a", "b"])
@pytest.mark.parametrize("kind", C.SAMPLER_KINDS)
def test_draws_are_bit_equal_to_reference(kind, cfg_name):
    _, _, _, vals = _port_draws(kind, cfg_name)
    head = _GOLDEN[f"{kind}_{cfg_name}_head"]
    got_head = np.stack([v[:C.DRAW_KEEP] for v in vals])
    bad = np.nonzero((got_head.view(np.uint32) != head.view(np.uint32))
                     .any(axis=1))[0]
    assert bad.size == 0, f"draws (dim, component) {[divmod(int(b), 3) for b in bad]}"
    got = C.digests(vals)
    want = _GOLDEN[f"{kind}_{cfg_name}_digest"]
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, f"draws (dim, component) {[divmod(int(b), 3) for b in bad]}"
    assert all(((v >= 0.0) & (v < 1.0)).all() for v in vals)


@pytest.mark.parametrize("kind", C.SAMPLER_KINDS)
def test_get_1d_run_columns_equal_get_1d(kind):
    s, pixel, sample, _ = _port_draws(kind, "b", n=512)
    run = s.get_1d_run(pixel, sample, 7, 5)
    for j in range(5):
        assert torch.equal(run[:, j], s.get_1d(pixel, sample, 7 + j)), j


def test_sobol_bits_equal_the_reference_loop():
    m = sobol.matrices_np()
    ref = np.load(os.path.join(REF_DATA, "sobol_matrices.npy"))
    assert np.array_equal(m, ref)
    idx = np.random.default_rng(0).integers(0, 1 << 32, 2048, dtype=np.uint64)
    idx[:4] = (0, 1, (1 << 32) - 1, 1 << 31)
    for dim in (0, 1, 2, 77, 255, 256 + 3):
        row = m[dim % 256].astype(np.uint64)
        want = np.zeros_like(idx)
        for b in range(32):  # the reference's fori_loop
            want ^= ((idx >> np.uint64(b)) & np.uint64(1)) * row[b]
        got = sobol.sobol_bits(torch.from_numpy(idx.astype(np.int64)), dim)
        assert np.array_equal(got.numpy().astype(np.uint64), want), dim


@pytest.mark.parametrize("base", [3, 7, 131])
def test_scrambled_radical_inverse_matches_reference(base):
    import jax
    import jax.numpy as jnp

    from pbrt_tpu.samplers import samplers as ref
    from pbrt_tpu_torch.samplers.samplers import _scrambled_radical_inverse

    idx = np.random.default_rng(base).integers(0, 1 << 32, 4096,
                                               dtype=np.uint64)
    want = jax.jit(lambda i: ref._scrambled_radical_inverse(i, base, 77))(
        jnp.asarray(idx.astype(np.uint32)))
    got = _scrambled_radical_inverse(torch.from_numpy(idx.astype(np.int64)),
                                     base, 77)
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(want).view(np.uint32))


def test_pmj02_tables_equal_the_reference():
    pts, bn = pmj02.load_tables()
    assert np.array_equal(pts, np.load(os.path.join(REF_DATA,
                                                    "pmj02_tables.npy")))
    assert np.array_equal(bn, np.load(os.path.join(REF_DATA, "bluenoise.npy")))
    assert np.array_equal(pmj02.generate_pmj02_table(pmj02.TABLE_SIZE, 5),
                          pts[5])


def test_integer_steps_keep_32_bits():
    # spp 12: (s + h) wraps at 2^32 before % spp.
    s = Sampler.create("padded", spp=12, seed=1)
    pixel = torch.arange(4096)
    h = s._hash(pixel, 3)
    sidx = torch.full_like(pixel, 0xFFFFFF00)
    want = ((sidx + h) % (1 << 32)) % 12
    assert torch.equal(s._shuffled_index(pixel, sidx, 3), want)
    assert bool(((sidx + h) >= (1 << 32)).any())
    # ZSobol with 32 index bits: the top digit's hash is the hash of 0.
    z = Sampler.create("zsobol", spp=16, nx=0, log2_res=14)
    idx = z._zsobol_index(pixel, torch.zeros_like(pixel), 2)
    assert bool((idx < (1 << 32)).all()) and bool((idx >= 0).all())


def test_unknown_kind_and_per_lane_dimensions_raise():
    with pytest.raises(ValueError, match="unknown sampler kind"):
        Sampler(kind="owen")
    with pytest.raises(ValueError, match="one dimension for every lane"):
        Sampler.create("sobol").get_1d(torch.arange(4), 0, torch.arange(4))


def test_sampler_converts_from_reference():
    from pbrt_tpu.samplers.samplers import Sampler as JaxSampler
    from pbrt_tpu_torch.convert import sampler_from_arrays

    from .torch_port_helpers import flatten_jax

    j = JaxSampler.create("halton", spp=12, seed=5, nx=20, log2_res=5)
    assert sampler_from_arrays(*flatten_jax(j)) == Sampler.create(
        "halton", spp=12, seed=5, nx=20, log2_res=5)
