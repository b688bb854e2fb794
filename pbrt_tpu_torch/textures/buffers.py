"""Texture tables and their branch-free per-ray evaluation (port of
pbrt_tpu/textures/buffers.py; the reference renderer's textures.h).

One row per texture. Evaluation computes every family present for every
ray and selects on the kind tag: constant, checkerboard, marble, fBm,
wrinkled, windy, bilerp, dots and image (a MIP pyramid in one flat texel
table), Ptex (per-face texel sets resampled to one shared R x R grid,
looked up by the hit's face id) and the families that reference other
textures (scale, mix, directionmix, checkerboard with texture arms)
through two static levels of sub-texture ids. The texture coordinates
come from the uv, spherical, cylindrical or planar mapping. Values are
linear RGB; a material's textured albedo is fitted per ray to sigmoid
coefficients (core/rgb2spec.py `fit_albedo_rays`).

The tables are built on the host in numpy, bit-equal to the reference's;
no tensor here is trainable.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import mipmap as mip
from ..core import noise, rgb2spec
from ..core import rng
from ..core.floats import fma
from ..core.take import take
from ..core.tensorclass import static_field, tensorclass

TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_MARBLE = 3
TEX_SCALE = 4
TEX_MIX = 5
TEX_DIRECTIONMIX = 6
TEX_BILERP = 7
TEX_DOTS = 8
TEX_FBM = 9
TEX_WINDY = 10
TEX_WRINKLED = 11
TEX_PTEX = 12

MAP_UV = 0
MAP_SPHERICAL = 1
MAP_CYLINDRICAL = 2
MAP_PLANAR = 3

_KIND_NAMES = {
    "constant": TEX_CONSTANT, "checkerboard": TEX_CHECKER,
    "checker": TEX_CHECKER, "imagemap": TEX_IMAGE, "image": TEX_IMAGE,
    "marble": TEX_MARBLE, "scale": TEX_SCALE, "mix": TEX_MIX,
    "directionmix": TEX_DIRECTIONMIX, "bilerp": TEX_BILERP,
    "dots": TEX_DOTS, "fbm": TEX_FBM, "windy": TEX_WINDY,
    "wrinkled": TEX_WRINKLED, "ptex": TEX_PTEX,
}
_MAP_NAMES = {
    "uv": MAP_UV, "spherical": MAP_SPHERICAL,
    "cylindrical": MAP_CYLINDRICAL, "planar": MAP_PLANAR,
}
_ROW_KEYS = ("kind", "rgb0", "rgb1", "rgb2", "rgb3", "f0", "sub0", "sub1",
             "sub2", "mapping", "uscale", "vscale", "udelta", "vdelta",
             "aux0", "aux1", "img_index", "ptex_index")


def _resample(im, h, w):
    """Bilinear resample of an (H, W, 3) image to (h, w), as the
    reference does before every image shares one mip layout."""
    yy = np.clip(np.linspace(0, im.shape[0] - 1, h), 0, im.shape[0] - 1)
    xx = np.clip(np.linspace(0, im.shape[1] - 1, w), 0, im.shape[1] - 1)
    y0 = yy.astype(int)
    x0 = xx.astype(int)
    y1 = np.minimum(y0 + 1, im.shape[0] - 1)
    x1 = np.minimum(x0 + 1, im.shape[1] - 1)
    fy = (yy - y0)[:, None, None]
    fx = (xx - x0)[None, :, None]
    return (
        im[y0][:, x0] * (1 - fy) * (1 - fx)
        + im[y0][:, x1] * (1 - fy) * fx
        + im[y1][:, x0] * fy * (1 - fx)
        + im[y1][:, x1] * fy * fx
    )


def _ptex_tables(stacks):
    """Every face of every Ptex texture resampled (nearest texel) onto one
    shared R x R grid, R the largest face side as a power of two in
    [4, 64], as the reference does: (flat, base, nfaces, R)."""
    if not stacks:
        return (np.zeros((0, 1, 1, 3), np.float32), np.zeros((0,), np.int32),
                np.zeros((0,), np.int32), 1)
    res = 4
    for st in stacks:
        for f in st:
            res = max(res, f.shape[0], f.shape[1])
    res = min(1 << (res - 1).bit_length(), 64)
    rows, bases, counts = [], [], []
    for st in stacks:
        bases.append(len(rows))
        counts.append(len(st))
        for f in st:
            f = np.asarray(f, np.float32)
            if f.shape[-1] == 1:
                f = np.repeat(f, 3, axis=-1)
            yy = np.clip(np.arange(res) * f.shape[0] // res, 0, f.shape[0] - 1)
            xx = np.clip(np.arange(res) * f.shape[1] // res, 0, f.shape[1] - 1)
            rows.append(f[yy][:, xx, :3])
    return (np.ascontiguousarray(np.stack(rows), np.float32),
            np.asarray(bases, np.int32), np.asarray(counts, np.int32), int(res))


@tensorclass
class TextureBuffers:
    kind: torch.Tensor  # (T,) int32 TEX_*
    # Colors: rgb0/rgb1 (two-color families), rgb2/rgb3 (bilerp corners).
    rgb0: torch.Tensor  # (T, 3)
    rgb1: torch.Tensor  # (T, 3)
    rgb2: torch.Tensor  # (T, 3)
    rgb3: torch.Tensor  # (T, 3)
    f0: torch.Tensor  # (T,) scale factor / mix amount
    sub0: torch.Tensor  # (T,) int32 sub-texture id or -1 (-> rgb0)
    sub1: torch.Tensor  # (T,) int32 sub-texture id or -1 (-> rgb1)
    sub2: torch.Tensor  # (T,) int32 amount sub-texture id or -1 (-> f0)
    mapping: torch.Tensor  # (T,) int32 MAP_*
    uscale: torch.Tensor  # (T,)
    vscale: torch.Tensor  # (T,)
    udelta: torch.Tensor  # (T,)
    vdelta: torch.Tensor  # (T,)
    aux0: torch.Tensor  # (T, 3) planar v1 / directionmix direction
    aux1: torch.Tensor  # (T, 3) planar v2
    # Image textures: every image resampled to one power-of-two size, its
    # pyramid flattened; image i's texels start at row i of img_flat.
    img_index: torch.Tensor  # (T,) int32 image id or -1
    img_flat: torch.Tensor  # (I, TX, 3)
    # Ptex textures (textures.h PtexTexture): every face of every Ptex
    # texture resampled to one shared R x R grid (R = ptex_res).
    ptex_index: torch.Tensor  # (T,) int32 Ptex id or -1
    ptex_flat: torch.Tensor  # (total faces, R, R, 3)
    ptex_base: torch.Tensor  # (P,) int32 first face row of each Ptex texture
    ptex_nfaces: torch.Tensor  # (P,) int32 face count of each
    img_offsets: tuple = static_field(default=())
    img_widths: tuple = static_field(default=())
    img_heights: tuple = static_field(default=())
    n_textures: int = static_field(default=0)
    # The families present and whether a row references a sub-texture:
    # evaluation traces only what the table holds.
    families: tuple = static_field(default=())
    has_refs: bool = static_field(default=False)
    has_ptex: bool = static_field(default=False)
    ptex_res: int = static_field(default=1)
    # mipmap.level_table of the image pyramid, on img_flat's device.
    # Derived.
    img_levels: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "img_levels", mip.level_table(
            self.img_offsets, self.img_widths, self.img_heights,
            self.img_flat.device))

    @staticmethod
    def build(specs) -> "TextureBuffers":
        """specs: list of dicts with keys kind (name), rgb0..rgb3, f0,
        sub0/sub1/sub2 (texture ids), mapping (name), uscale/vscale/
        udelta/vdelta, aux0/aux1, rgb_image ((H, W, 3)) for images and
        ptex_faces (a list of (h, w, c) arrays, one per face) for Ptex."""
        n = len(specs)
        kinds = np.asarray([_KIND_NAMES[s["kind"]] for s in specs], np.int32)
        maps = np.asarray([_MAP_NAMES[s.get("mapping", "uv")] for s in specs],
                          np.int32)
        images, img_idx = [], []
        for s in specs:
            if s["kind"] in ("image", "imagemap"):
                img_idx.append(len(images))
                images.append(np.asarray(s["rgb_image"], np.float32))
            else:
                img_idx.append(-1)
        ptex_idx, ptex_stacks = [], []
        for s in specs:
            if s["kind"] == "ptex":
                ptex_idx.append(len(ptex_stacks))
                ptex_stacks.append(s["ptex_faces"])
            else:
                ptex_idx.append(-1)
        ptex_flat, ptex_base, ptex_nfaces, ptex_res = _ptex_tables(ptex_stacks)

        if images:
            h = 1 << (max(im.shape[0] for im in images) - 1).bit_length()
            w = 1 << (max(im.shape[1] for im in images) - 1).bit_length()
            flats = []
            for im in images:
                m = mip.MIPMap.build(_resample(im, h, w))
                flats.append(m.flat.numpy())
                offs, ws, hs = m.offsets, m.widths, m.heights
            img_flat = np.stack(flats)
        else:
            img_flat = np.zeros((0, 1, 3), np.float32)
            offs, ws, hs = (0,), (1,), (1,)

        def vec3(key, default):
            rows = [np.broadcast_to(np.asarray(s.get(key, default), np.float32),
                                    (3,)) for s in specs]
            return torch.from_numpy(
                np.asarray(rows or np.zeros((0, 3)), np.float32).reshape(n, 3))

        def scal(key, default, dtype=np.float32):
            return torch.from_numpy(
                np.asarray([s.get(key, default) for s in specs], dtype)
                .reshape(n))

        return TextureBuffers(
            kind=torch.from_numpy(kinds.reshape(n)),
            rgb0=vec3("rgb0", (0.0, 0.0, 0.0)),
            rgb1=vec3("rgb1", (1.0, 1.0, 1.0)),
            rgb2=vec3("rgb2", (0.0, 0.0, 0.0)),
            rgb3=vec3("rgb3", (1.0, 1.0, 1.0)),
            f0=scal("f0", 1.0),
            sub0=scal("sub0", -1, np.int32),
            sub1=scal("sub1", -1, np.int32),
            sub2=scal("sub2", -1, np.int32),
            mapping=torch.from_numpy(maps.reshape(n)),
            uscale=scal("uscale", 1.0),
            vscale=scal("vscale", 1.0),
            udelta=scal("udelta", 0.0),
            vdelta=scal("vdelta", 0.0),
            aux0=vec3("aux0", (1.0, 0.0, 0.0)),
            aux1=vec3("aux1", (0.0, 1.0, 0.0)),
            img_index=torch.from_numpy(np.asarray(img_idx, np.int32).reshape(n)),
            img_flat=torch.from_numpy(np.ascontiguousarray(img_flat, np.float32)),
            ptex_index=torch.from_numpy(
                np.asarray(ptex_idx, np.int32).reshape(n)),
            ptex_flat=torch.from_numpy(ptex_flat),
            ptex_base=torch.from_numpy(ptex_base),
            ptex_nfaces=torch.from_numpy(ptex_nfaces),
            ptex_res=ptex_res,
            img_offsets=tuple(offs),
            img_widths=tuple(ws),
            img_heights=tuple(hs),
            n_textures=n,
            has_ptex=bool(ptex_stacks),
            families=tuple(sorted(set(int(k) for k in kinds))),
            has_refs=any(
                int(s.get("sub0", -1)) >= 0 or int(s.get("sub1", -1)) >= 0
                or int(s.get("sub2", -1)) >= 0
                for s in specs
            ),
        )


def _map_uv(row, uv, p_world):
    """The row's texture-coordinate mapping (textures.h UVMapping,
    SphericalMapping, CylindricalMapping, PlanarMapping)."""
    mapping = row["mapping"]
    us, vs = row["uscale"], row["vscale"]
    ud, vd = row["udelta"], row["vdelta"]
    u0 = uv[..., 0] * us + ud
    v0 = uv[..., 1] * vs + vd

    r = torch.sqrt(torch.clamp(torch.sum(p_world * p_world, -1), min=1e-12))
    theta = torch.arccos(torch.clamp(p_world[..., 2] / r, -1.0, 1.0))
    phi = torch.atan2(p_world[..., 1], p_world[..., 0])
    sph_u = phi / (2.0 * math.pi) * us + ud
    sph_v = theta / math.pi * vs + vd
    cyl_u = phi / (2.0 * math.pi) * us + ud
    cyl_v = p_world[..., 2] * vs + vd
    pla_u = torch.sum(p_world * row["aux0"], -1) + ud
    pla_v = torch.sum(p_world * row["aux1"], -1) + vd

    u = torch.where(
        mapping == MAP_SPHERICAL, sph_u,
        torch.where(mapping == MAP_CYLINDRICAL, cyl_u,
                    torch.where(mapping == MAP_PLANAR, pla_u, u0)),
    )
    v = torch.where(
        mapping == MAP_SPHERICAL, sph_v,
        torch.where(mapping == MAP_CYLINDRICAL, cyl_v,
                    torch.where(mapping == MAP_PLANAR, pla_v, v0)),
    )
    return u, v


def _gather_row(tex, tid):
    return {k: take(getattr(tex, k), tid) for k in _ROW_KEYS}


def _image_lookup(tex, row, u, v, width):
    """Trilinear lookup of each ray's image in the shared flat table."""
    if tex.img_flat.shape[0] == 0:
        return torch.zeros(u.shape + (3,), dtype=torch.float32, device=u.device)
    # ImageTextureBase flips t (textures.cpp): images index top-down,
    # texture space runs bottom-up.
    v = 1.0 - v
    ii = torch.clamp(row["img_index"], 0, tex.img_flat.shape[0] - 1)
    per = tex.img_flat.shape[1]
    flat = tex.img_flat.reshape(-1, 3)
    base = ii * per
    n_lv = len(tex.img_offsets)
    lod = n_lv - 1 + torch.log2(torch.clamp(width, min=1e-8))
    lod = torch.clamp(lod, 0.0, n_lv - 1 - 1e-4)
    l0 = torch.floor(lod).to(torch.int32)
    f = (lod - l0)[..., None]
    u1 = torch.remainder(u, 1.0)
    v1 = torch.remainder(v, 1.0)

    def bil(li):
        offs, w, h = tex.img_levels[:, li.long()]
        x = u1 * w.to(torch.float32) - 0.5
        y = v1 * h.to(torch.float32) - 0.5
        x0 = torch.floor(x).to(torch.int32)
        y0 = torch.floor(y).to(torch.int32)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]

        def tx(xi, yi):
            # Floor-mod wrap (jnp.mod): x0 - 1 may be -1 at the left edge.
            idx = base + offs + torch.remainder(yi, h) * w + torch.remainder(xi, w)
            return take(flat, idx.long())

        return (
            tx(x0, y0) * (1 - fx) * (1 - fy)
            + tx(x0 + 1, y0) * fx * (1 - fy)
            + tx(x0, y0 + 1) * (1 - fx) * fy
            + tx(x0 + 1, y0 + 1) * fx * fy
        )

    # With no footprint the level is 0 and the upper level's weight is 0;
    # it is computed all the same, as in the reference (finite texels).
    return bil(l0) * (1 - f) + bil(l0 + 1) * f


def _eval_leaf(tex, tid, uv, p_world, width, face=None):
    """RGB of the families that reference no other texture, at each ray.
    Families absent from tex.families are not traced. face: the hit's
    Ptex face id (None: face 0)."""
    fam = set(tex.families) if tex.families else set(range(12))
    row = _gather_row(tex, tid)
    kind = row["kind"]
    u, v = _map_uv(row, uv, p_world)
    c0, c1 = row["rgb0"], row["rgb1"]

    out = c0  # constant

    if TEX_CHECKER in fam:
        par = torch.remainder(torch.floor(u) + torch.floor(v), 2.0)
        out = torch.where(
            (kind == TEX_CHECKER)[..., None],
            torch.where((par == 0.0)[..., None], c0, c1), out,
        )

    if TEX_MARBLE in fam:
        m = noise.fbm(p_world * row["uscale"][..., None], octaves=4)
        tmix = 0.5 + 0.5 * torch.sin(
            row["uscale"]
            * (p_world[..., 0] + p_world[..., 1] + p_world[..., 2])
            + 4.0 * m
        )
        out = torch.where(
            (kind == TEX_MARBLE)[..., None],
            c0 * (1.0 - tmix[..., None]) + c1 * tmix[..., None], out,
        )

    # FBm, wrinkled and windy: scalar noise times rgb1 (the reference's
    # float texture families, textures.h).
    if TEX_FBM in fam:
        fbm_v = noise.fbm(p_world, octaves=6)
        out = torch.where(
            (kind == TEX_FBM)[..., None], (0.5 + 0.5 * fbm_v)[..., None] * c1,
            out,
        )
    if TEX_WRINKLED in fam:
        turb = noise.turbulence(p_world, octaves=6)
        out = torch.where(
            (kind == TEX_WRINKLED)[..., None], turb[..., None] * c1, out)
    if TEX_WINDY in fam:
        wind = torch.abs(noise.fbm(0.1 * p_world, octaves=3)) * noise.fbm(
            p_world, octaves=6)
        out = torch.where(
            (kind == TEX_WINDY)[..., None], (0.5 + 0.5 * wind)[..., None] * c1,
            out,
        )

    if TEX_BILERP in fam:
        fu = torch.remainder(u, 1.0)
        fv = torch.remainder(v, 1.0)
        bil = (
            row["rgb0"] * ((1 - fu) * (1 - fv))[..., None]
            + row["rgb1"] * (fu * (1 - fv))[..., None]
            + row["rgb2"] * ((1 - fu) * fv)[..., None]
            + row["rgb3"] * (fu * fv)[..., None]
        )
        out = torch.where((kind == TEX_BILERP)[..., None], bil, out)

    if TEX_DOTS in fam:
        # A hash-jittered dot per uv cell; the cell ids are int32 as in
        # the reference, and the hash reads their two's-complement bits.
        cu = torch.floor(u + 0.5)
        cv = torch.floor(v + 0.5)
        h0, h1, h2, _ = rng.pcg4d(cu.to(torch.int32), cv.to(torch.int32), 17, 29)
        has_dot = rng.u32_to_uniform(h0) < 0.5
        cx = cu + 0.35 * (rng.u32_to_uniform(h1) - 0.5)
        cy = cv + 0.35 * (rng.u32_to_uniform(h2) - 0.5)
        rad = 0.35
        inside = has_dot & ((u - cx) ** 2 + (v - cy) ** 2 < rad * rad)
        out = torch.where(
            (kind == TEX_DOTS)[..., None],
            torch.where(inside[..., None], c0, c1), out,
        )

    if tex.img_flat.shape[0] > 0:
        img = _image_lookup(tex, row, u, v, width)
        out = torch.where((kind == TEX_IMAGE)[..., None], img, out)

    if tex.has_ptex:
        out = torch.where((kind == TEX_PTEX)[..., None],
                          _ptex_lookup(tex, row, u, v, face), out)
    return out


def _ptex_lookup(tex, row, u, v, face):
    """Bilinear lookup in the hit face's texels with clamp addressing at
    the face's borders (the reference's; no cross-face filtering), times
    the row's scale. face None is face 0."""
    pi = torch.clamp(row["ptex_index"], 0, tex.ptex_base.shape[0] - 1).long()
    fbase = tex.ptex_base[pi]
    nf = tex.ptex_nfaces[pi]
    fid = torch.zeros_like(fbase) if face is None else face.to(fbase.dtype)
    fi = fbase + torch.minimum(torch.clamp(fid, min=0), nf - 1)
    R = tex.ptex_res
    flat = tex.ptex_flat.reshape(-1, 3)
    x = torch.clamp(u, 0.0, 1.0) * R - 0.5
    y = torch.clamp(v, 0.0, 1.0) * R - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def ptx(xi, yi):
        xi = torch.clamp(xi, 0, R - 1)
        yi = torch.clamp(yi, 0, R - 1)
        return take(flat, ((fi * R + yi) * R + xi).long())

    # The reference's jitted sum, whose adds XLA's CPU build contracts
    # into multiply-adds (bit-equal on random uv and faces,
    # tests/test_torch_io.py).
    acc = fma(ptx(x0, y0) * (1 - fx), 1 - fy, ptx(x0 + 1, y0) * fx * (1 - fy))
    acc = fma(ptx(x0, y0 + 1) * (1 - fx), fy, acc)
    acc = fma(ptx(x0 + 1, y0 + 1) * fx, fy, acc)
    return acc * row["f0"][..., None]


def _eval(tex, tid, uv, p_world, width, n_shade, depth, face=None):
    """Evaluate with `depth` static levels of sub-texture indirection left:
    scale, mix, directionmix and checkerboard with texture arms resolve
    their sub ids one level down; at depth 0 their constant colors stand
    in."""
    row = _gather_row(tex, tid)
    kind = row["kind"]
    out = _eval_leaf(tex, tid, uv, p_world, width, face)

    fam = set(tex.families) if tex.families else set(range(12))
    if not (tex.has_refs or fam & {TEX_SCALE, TEX_MIX, TEX_DIRECTIONMIX}):
        return out

    def sub_val(sub_id, const_rgb):
        if depth == 0:
            return const_rgb
        sid = torch.clamp(sub_id, 0, tex.n_textures - 1)
        val = _eval(tex, sid, uv, p_world, width, n_shade, depth - 1, face)
        return torch.where((sub_id >= 0)[..., None], val, const_rgb)

    v0 = sub_val(row["sub0"], row["rgb0"])
    v1 = sub_val(row["sub1"], row["rgb1"])
    ones = torch.ones((1, 3), dtype=torch.float32, device=uv.device)
    amt = torch.where(
        row["sub2"] >= 0,
        torch.mean(sub_val(row["sub2"], row["f0"][..., None] * ones), dim=-1),
        row["f0"],
    )

    out = torch.where((kind == TEX_SCALE)[..., None], v0 * amt[..., None], out)
    mixv = v0 * (1 - amt[..., None]) + v1 * amt[..., None]
    out = torch.where((kind == TEX_MIX)[..., None], mixv, out)
    if n_shade is not None:
        # DirectionMix (textures.h): amount = max(0, dot(dir, n)).
        damt = torch.clamp(torch.sum(row["aux0"] * n_shade, -1), min=0.0)
        dmix = v0 * damt[..., None] + v1 * (1 - damt[..., None])
        out = torch.where((kind == TEX_DIRECTIONMIX)[..., None], dmix, out)
    # A checkerboard with texture arms selects between the sub values.
    u, v = _map_uv(row, uv, p_world)
    par = torch.remainder(torch.floor(u) + torch.floor(v), 2.0)
    has_sub = (row["sub0"] >= 0) | (row["sub1"] >= 0)
    chk = torch.where((par == 0.0)[..., None], v0, v1)
    return torch.where(((kind == TEX_CHECKER) & has_sub)[..., None], chk, out)


def evaluate_rgb(tex, tex_id, uv, p_world, width=None, n_shade=None,
                 face=None):
    """Linear-RGB texture value per ray; rows of tex_id -1 evaluate
    texture 0 (callers mask them). width: the screen footprint in uv units
    that picks the mip level (0: the finest); face: the Ptex face id per
    ray (None: face 0)."""
    if tex is None or tex.n_textures == 0:
        return torch.zeros(uv.shape[:-1] + (3,), dtype=torch.float32,
                           device=uv.device)
    if width is None:
        width = torch.zeros(uv.shape[:-1], dtype=torch.float32, device=uv.device)
    tid = torch.clamp(tex_id, 0, tex.n_textures - 1)
    return _eval(tex, tid, uv, p_world, width, n_shade, depth=2, face=face)


def evaluate_albedo_coeffs(tex, tex_id, uv, p_world, base_coeffs, width=None,
                           n_shade=None, face=None):
    """Per-ray albedo sigmoid coefficients with textures applied: tex_id
    (N,) texture id per ray (-1 keeps base_coeffs (N, 3)), uv (N, 2),
    p_world (N, 3). The fit runs for every ray, as in the reference."""
    if tex is None or tex.n_textures == 0:
        return base_coeffs
    rgb = torch.clamp(
        evaluate_rgb(tex, tex_id, uv, p_world, width, n_shade, face), 0.0, 1.0)
    coeffs = rgb2spec.fit_albedo_rays(rgb, iters=12)
    return torch.where((tex_id >= 0)[..., None], coeffs, base_coeffs)


def evaluate_float(tex, tex_id, uv, p_world, base_value, width=None,
                   face=None):
    """A float texture channel (roughness and the like): the mean of the
    RGB value."""
    if tex is None or tex.n_textures == 0:
        return base_value
    val = torch.mean(
        evaluate_rgb(tex, tex_id, uv, p_world, width, face=face), dim=-1)
    return torch.where(tex_id >= 0, val, base_value)
