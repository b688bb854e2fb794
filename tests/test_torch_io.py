"""The port's scene inputs (pbrt_tpu_torch/io/image.py, ptex.py,
nanovdb.py, buffercache.py; the Ptex tables and lookup of
textures/buffers.py; the parser's ptex texture and nanovdb medium)
against the reference on the CPU.

- Bytes: for the same arrays the port's writers and the reference's give
  byte-equal files (PFM, PNG, EXR with NONE / ZIP and half / float, QOI,
  Ptex of each data type and NanoVDB with NONE / ZIP), and the port's
  readers return bit-equal arrays from files the reference wrote. The
  cases mirror tests/test_io_image.py, test_ptex.py, test_nanovdb.py and
  test_buffercache.py.
- Lookups: evaluate_rgb with `face` bit-equal to the reference's jitted
  evaluation on random uv and face ids (out-of-range faces and uv
  included), evaluate_float within one ulp, and the albedo fit's
  coefficients on the shares of tests/test_torch_textures.py.
- Parsing: io_surfaces.pbrt and io_smoke.pbrt build the reference's scene
  member for member, bit for bit (tri_face, the Ptex tables, the image
  tables, the environment map, the medium's density and bounds).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pbrt_tpu.io import buffercache as jbc
from pbrt_tpu.io import image as jimage
from pbrt_tpu.io import nanovdb as jnvdb
from pbrt_tpu.io import ptex as jptex
from pbrt_tpu.io.parser import load_pbrt as jax_load_pbrt
from pbrt_tpu.textures import buffers as jtex
from pbrt_tpu_torch.io import buffercache as pbc
from pbrt_tpu_torch.io import image as pimage
from pbrt_tpu_torch.io import nanovdb as pnvdb
from pbrt_tpu_torch.io import ptex as pptex
from pbrt_tpu_torch.io.parser import load_pbrt, load_pbrt_string
from pbrt_tpu_torch.textures import buffers as ptex_buffers

from . import torch_port_io as io
from .test_torch_parser import _assert_same_build

torch.set_num_threads(2)


def _img(h=17, w=23, c=3, seed=0, lo=-2.0, hi=8.0):
    r = np.random.default_rng(seed)
    return r.uniform(lo, hi, size=(h, w, c)).astype(np.float32)


def _qoi_img(c, seed=3):
    """tests/test_io_image.py's QOI image: runs, index hits, small diffs."""
    rng = np.random.default_rng(seed)
    img = (rng.random((23, 17, c)) * 255).astype(np.uint8)
    img[5:9] = img[4]
    img[:, 3] = img[:, 2]
    img[10, :] = np.clip(img[9, :].astype(int) + 1, 0, 255)
    return img


def _ptex_faces(seed=0, n=5, c=3):
    rng = np.random.default_rng(seed)
    faces = [rng.random((1 << rng.integers(0, 4),) * 2 + (c,)).astype(
        np.float32) for _ in range(n)]
    faces.append(np.full((4, 4, c), 0.25, np.float32))  # a constant face
    return faces


def _nvdb_grid(m, shape=(9, 12, 20), ijk=(-5, 3, -2), vs=0.5, seed=0,
               name="density"):
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.0, 2.0, size=shape).astype(np.float32)
    return m.NVDBGrid(name=name, values=vals, ijk_min=np.array(ijk, np.int32),
                      voxel_size=np.full(3, vs), grid_class=m.GRID_CLASS_FOG)


def _sparse_grid(m):
    vals = np.zeros((32, 32, 32), np.float32)
    vals[4:7, 9:14, 20:25] = 3.25
    return m.NVDBGrid(name="density", values=vals,
                      ijk_min=np.zeros(3, np.int32), background=0.0)


# (file name, writer(module of the package, path)): each written by both
# packages, then read back by both.
WRITES = {
    "pfm_rgb": ("x.pfm", lambda m, p: m.write_pfm(p, _img())),
    "pfm_gray": ("g.pfm", lambda m, p: m.write_pfm(p, _img(c=1)[..., 0])),
    "png_float": ("x.png", lambda m, p: m.write_png(
        p, np.clip(_img(9, 13) / 8.0, 0, 1))),
    "png_uint8": ("u.png", lambda m, p: m.write_png(p, _qoi_img(3))),
    "png_gray": ("gr.png", lambda m, p: m.write_png(
        p, np.clip(_img(9, 13, 1)[..., 0] / 8.0, 0, 1))),
    "exr_none": ("n.exr", lambda m, p: m.write_exr(
        p, _img(), compression="none", metadata={"samplesPerPixel": "64"})),
    "exr_zip": ("z.exr", lambda m, p: m.write_exr(p, _img(37, 11),
                                                  compression="zip")),
    "exr_zip_half": ("h.exr", lambda m, p: m.write_exr(
        p, _img(40, 8), compression="zip", half=True)),
    "exr_none_half": ("nh.exr", lambda m, p: m.write_exr(
        p, _img(8, 8), compression="none", half=True)),
    "exr_channels": ("c.exr", lambda m, p: m.write_exr(
        p, _img(6, 5, 2), channel_names=["Y", "A"])),
    "qoi_rgb": ("x.qoi", lambda m, p: m.write_qoi(p, _qoi_img(3))),
    "qoi_rgba": ("x4.qoi", lambda m, p: m.write_qoi(p, _qoi_img(4, 5))),
    "ptex_uint8": ("u8.ptx", lambda m, p: m.write_ptex(
        p, _ptex_faces(1), datatype=m.DT_UINT8)),
    "ptex_uint16": ("u16.ptx", lambda m, p: m.write_ptex(
        p, _ptex_faces(2), datatype=m.DT_UINT16)),
    "ptex_half": ("h.ptx", lambda m, p: m.write_ptex(
        p, _ptex_faces(3), datatype=m.DT_HALF)),
    "ptex_float": ("f.ptx", lambda m, p: m.write_ptex(
        p, _ptex_faces(4, c=1), datatype=m.DT_FLOAT,
        meshtype=m.MT_TRIANGLE)),
    "nvdb_none": ("n.nvdb", lambda m, p: m.write_nanovdb(p, _nvdb_grid(m))),
    "nvdb_zip": ("z.nvdb", lambda m, p: m.write_nanovdb(
        p, _nvdb_grid(m), codec="zip")),
    "nvdb_multi_node": ("b.nvdb", lambda m, p: m.write_nanovdb(
        p, _nvdb_grid(m, shape=(6, 10, 140), ijk=(-70, 0, -3), seed=1))),
    "nvdb_sparse": ("s.nvdb", lambda m, p: m.write_nanovdb(
        p, _sparse_grid(m), codec="zip")),
    "nvdb_two_grids": ("t.nvdb", lambda m, p: m.write_nanovdb(
        p, [_nvdb_grid(m, seed=2),
            _nvdb_grid(m, seed=3, name="temperature")], codec="zip")),
}


def _module(case, pkg):
    ext = WRITES[case][0].rsplit(".", 1)[1]
    return {"ptx": {"jax": jptex, "port": pptex},
            "nvdb": {"jax": jnvdb, "port": pnvdb}}.get(
                ext, {"jax": jimage, "port": pimage})[pkg]


def _read_all(case, path, pkg):
    """Every reader of the package that takes the file, as a flat dict of
    arrays and values."""
    m = _module(case, pkg)
    ext = path.rsplit(".", 1)[1]
    if ext == "ptx":
        faces, mt = m.read_ptex(path)
        return {"meshtype": mt, **{f"face{i}": f for i, f in enumerate(faces)}}
    if ext == "nvdb":
        out = {}
        for name, g in sorted(m.read_nanovdb(path).items()):
            for key in ("values", "ijk_min", "voxel_size", "world_min",
                        "world_max", "grid_class", "background"):
                out[f"{name}.{key}"] = getattr(g, key)
            out[f"{name}.one"] = m.read_nanovdb(path, name).values
        return out
    out = {}
    if ext == "pfm":
        out["pfm"] = m.read_pfm(path)
    if ext == "png":
        out["png"] = m.read_png(path)
    if ext == "exr":
        img, chans, meta = m.read_exr(path)
        out.update(exr=img, chans=chans, meta=meta)
    if ext == "qoi":
        out["qoi"] = m.read_qoi(path)
    out["rgb"] = m.read_image_rgb(path)
    return out


@pytest.mark.parametrize("case", sorted(WRITES))
def test_writers_byte_equal_and_readers_bit_equal(case, tmp_path):
    name, write = WRITES[case]
    paths = {}
    for pkg in ("jax", "port"):
        os.makedirs(tmp_path / pkg)
        paths[pkg] = str(tmp_path / pkg / name)
        write(_module(case, pkg), paths[pkg])
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    want = _read_all(case, paths["jax"], "jax")
    got = _read_all(case, paths["jax"], "port")
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


def test_sparse_leaves_are_left_out(tmp_path):
    """tests/test_nanovdb.py's gate on the port's writer: a leaf holding
    only the background is not written."""
    sparse, dense = str(tmp_path / "a.nvdb"), str(tmp_path / "b.nvdb")
    g = _sparse_grid(pnvdb)
    pnvdb.write_nanovdb(sparse, g)
    pnvdb.write_nanovdb(dense, pnvdb.NVDBGrid(
        name="density", values=g.values + 1.0, ijk_min=np.zeros(3, np.int32)))
    assert (os.path.getsize(dense) - os.path.getsize(sparse)
            == 62 * pnvdb._LEAF_SIZE)
    np.testing.assert_array_equal(pnvdb.read_nanovdb(sparse, "density").values,
                                  g.values)


def test_unreadable_files_raise(tmp_path):
    """The readers' loud errors: an unknown image format, a file that is
    not Ptex or NanoVDB, a grid the file does not hold."""
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="unsupported image format"):
        pimage.read_image_rgb(str(bad))
    with pytest.raises(ValueError):
        pptex.read_ptex(str(bad))
    with pytest.raises(ValueError, match="not a NanoVDB file"):
        pnvdb.read_nanovdb(str(bad))
    good = str(tmp_path / "g.nvdb")
    pnvdb.write_nanovdb(good, _nvdb_grid(pnvdb))
    with pytest.raises(KeyError):
        pnvdb.read_nanovdb(good, "temperature")


@pytest.mark.parametrize("step", ["canonical", "ply", "parser"])
def test_buffer_cache_as_reference(step, tmp_path):
    """tests/test_buffercache.py's cases on both caches: the same sharing,
    the same counters."""
    caches = {"jax": jbc.BufferCache(), "port": pbc.BufferCache()}
    if step == "canonical":
        a = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
        for bc in caches.values():
            ca, cb = bc.canonical(a), bc.canonical(a.copy())
            assert ca is cb and not ca.flags.writeable
            assert bc.canonical(a * 2.0) is not ca
            assert bc.canonical(a.view(np.uint32)) is not ca
    elif step == "ply":
        from pbrt_tpu_torch.io.ply import write_ply

        verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                           np.float32)
        path = str(tmp_path / "quad.ply")
        write_ply(path, verts, np.asarray([[0, 1, 2], [1, 3, 2]], np.int32))
        for bc in caches.values():
            v1, f1 = bc.read_ply(path)
            v2, f2 = bc.read_ply(path)
            assert v1 is v2 and f1 is f2
            np.testing.assert_array_equal(v1, verts)
    else:
        tri = ('Shape "trianglemesh" "point3 P" [0 0 0  1 0 0  0 1 0] '
               '"integer indices" [0 1 2]\n')
        text = ("WorldBegin\nMaterial \"diffuse\"\n" + tri
                + "Translate 2 0 0\n" + tri + "Translate 2 0 0\n" + tri)
        from pbrt_tpu_torch.io.parser import PbrtParser

        parser = PbrtParser(str(tmp_path)).parse_string(text)
        scene = parser.build()[0]
        assert scene.geom.num_triangles == 3
        stats = parser.buffer_stats
        # Three meshes, each P and indices: the repeats are hits.
        assert stats == {"buffercache/lookups": 6, "buffercache/hits": 4,
                         "buffercache/redundant MB": 0}
        return
    want, got = caches["jax"], caches["port"]
    assert (got.lookups, got.hits, got.redundant_bytes) == (
        want.lookups, want.hits, want.redundant_bytes)
    assert got.report_stats() == {
        "buffercache/lookups": want.lookups, "buffercache/hits": want.hits,
        "buffercache/redundant MB": int(want.redundant_bytes / 2 ** 20)}


# Ptex tables of three textures (different face counts, sides, channel
# counts and scales) beside a constant row.
_PTEX_N = 20000


def _ptex_specs():
    rng = np.random.default_rng(0)
    faces = [rng.random((1 << rng.integers(0, 4),) * 2 + (3,)).astype(
        np.float32) for _ in range(7)]
    gray = [rng.random((8, 8, 1)).astype(np.float32) for _ in range(3)]
    big = [rng.random((128, 128, 3)).astype(np.float32) for _ in range(2)]
    return [{"kind": "ptex", "ptex_faces": faces, "f0": 0.7},
            {"kind": "constant", "rgb0": (0.1, 0.2, 0.3)},
            {"kind": "ptex", "ptex_faces": gray},
            {"kind": "ptex", "ptex_faces": big, "f0": 1.3}]


@pytest.fixture(scope="module")
def ptex_tables():
    specs = _ptex_specs()
    return (ptex_buffers.TextureBuffers.build(specs),
            jtex.TextureBuffers.build(specs))


def _ptex_rays(n_textures, seed=1):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.2, 1.2, (_PTEX_N, 2)).astype(np.float32)
    p = rng.normal(size=(_PTEX_N, 3)).astype(np.float32)
    tid = rng.integers(-1, n_textures, _PTEX_N).astype(np.int32)
    face = rng.integers(-1, 9, _PTEX_N).astype(np.int32)
    return uv, p, tid, face


def test_ptex_tables_bit_equal(ptex_tables):
    """The shared R x R table (R the largest side, capped at 64) and its
    offsets, bit for bit."""
    got, want = ptex_tables
    assert got.has_ptex and got.ptex_res == want.ptex_res == 64
    for key in ("ptex_index", "ptex_flat", "ptex_base", "ptex_nfaces"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(want, key)), key)


@pytest.mark.parametrize("fn", ["rgb", "float", "rgb_no_face"])
def test_ptex_lookup_bit_equal_to_jitted(ptex_tables, fn):
    """The per-face bilinear lookup with clamp addressing, the face ids
    clamped into each texture's faces (None: face 0), bit-equal to the
    reference's jitted evaluation (the port contracts the bilinear sum
    into multiply-adds as XLA's CPU build does); the float channel within
    one ulp."""
    got_t, want_t = ptex_tables
    uv, p, tid, face = _ptex_rays(got_t.n_textures)
    t = torch.from_numpy
    j = jnp.asarray
    if fn == "float":
        base = np.random.default_rng(2).uniform(0, 1, _PTEX_N).astype(np.float32)
        got = ptex_buffers.evaluate_float(got_t, t(tid), t(uv), t(p), t(base),
                                          face=t(face)).numpy()
        want = jax.jit(lambda tx, *a: jtex.evaluate_float(tx, *a[:4],
                                                          face=a[4]))(
            want_t, j(tid), j(uv), j(p), j(base), j(face))
    else:
        f = None if fn == "rgb_no_face" else face
        got = ptex_buffers.evaluate_rgb(got_t, t(tid), t(uv), t(p),
                                        face=None if f is None else t(f))
        got = got.numpy()
        want = jax.jit(lambda tx, a, b, c, d: jtex.evaluate_rgb(
            tx, a, b, c, face=d))(want_t, j(tid), j(uv), j(p),
                                  None if f is None else j(f))
    want = np.asarray(want)
    assert np.ptp(want) > 0.5
    if fn == "float":
        # The channel mean: XLA multiplies the sum by float32(1/3), torch
        # divides it by 3.
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    else:
        np.testing.assert_array_equal(got, want)


def test_ptex_albedo_coeffs_match(ptex_tables):
    """The fitted albedo of Ptex rows: rows of id -1 keep their base
    exactly; the fit's coefficients on tests/test_torch_textures.py's
    shares (>= 99.5% within 5e-3)."""
    got_t, want_t = ptex_tables
    uv, p, tid, face = _ptex_rays(got_t.n_textures, seed=3)
    base = np.random.default_rng(4).normal(size=(_PTEX_N, 3)).astype(np.float32)
    t = torch.from_numpy
    got = ptex_buffers.evaluate_albedo_coeffs(
        got_t, t(tid), t(uv), t(p), t(base), face=t(face)).numpy()
    want = np.asarray(jax.jit(lambda tx, a, b, c, d, e: (
        jtex.evaluate_albedo_coeffs(tx, a, b, c, d, face=e)))(
            want_t, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(p),
            jnp.asarray(base), jnp.asarray(face)))
    np.testing.assert_array_equal(got[tid < 0], base[tid < 0])
    ok = np.all(np.abs(got - want) <= 5e-3 + 5e-3 * np.abs(want), axis=-1)
    assert ok.mean() >= 0.995, int(np.sum(~ok))


@pytest.mark.parametrize("name", io.SCENES)
def test_io_scene_builds_the_reference_scene(name):
    """The parsed scene, member for member, bit for bit: the triangles'
    Ptex face ids, the Ptex and image tables, the environment map, and
    io_smoke's density grid (read (z, y, x)) with its world bounds through
    the CTM."""
    path = os.path.join(io.IO_DIR, name + ".pbrt")
    jax_built = jax_load_pbrt(path)
    port_built = load_pbrt(path, device="cpu")
    _assert_same_build(jax_built, port_built)
    ps = port_built[0]
    assert ps.small is not None and ps.geom.num_triangles <= 1024
    assert ps.textures.has_ptex
    faces = ps.geom.tri_face.numpy()
    if name == "io_surfaces":
        assert ps.textures.img_flat.shape[0] == 3 and ps.lights.env is not None
        # Each mesh numbers its triangles from 0: walls 0-1, the cube 0-11.
        np.testing.assert_array_equal(faces[:10], [0, 1] * 5)
        np.testing.assert_array_equal(faces[10:22], np.arange(12))
        assert ps.textures.ptex_nfaces.tolist() == [2, 2, 12]
    else:
        med = ps.medium
        n = io.SMALL["vdb"]
        assert tuple(med.density.shape) == (n, n, n)
        want = io.make_inputs(io.SMALL)["smoke"]
        np.testing.assert_array_equal(med.density.numpy(), want)
        np.testing.assert_allclose(med.bounds_lo.numpy(), [-0.6, 0.25, -0.6],
                                   atol=1e-6)
        np.testing.assert_allclose(med.bounds_hi.numpy(), [0.6, 1.05, 0.6],
                                   atol=1e-6)


def test_committed_inputs_are_the_writers_output(tmp_path):
    """The committed inputs are what tests/torch_port_io.py writes with the
    port's writers (the reference's wrote them)."""
    io.write_inputs("pbrt_tpu_torch", str(tmp_path), io.SMALL)
    for name in os.listdir(tmp_path):
        with open(tmp_path / name, "rb") as a, \
                open(os.path.join(io.IO_DIR, name), "rb") as b:
            assert a.read() == b.read(), name


def test_nanovdb_medium_without_filename_warns():
    """As in the reference: a nanovdb medium with no "filename" is skipped
    with a warning."""
    _, _, settings = load_pbrt_string(
        'MakeNamedMedium "v" "string type" "nanovdb"', device="cpu")
    assert settings["warnings"] == ["medium v: nanovdb needs filename"]
