"""Many-light BVH sampler (port of pbrt_tpu/lights/bvh.py; Conty Estevez &
Kulla's light tree, BVHLightSampler and LightBounds of the reference,
lightsamplers.h:102-320, lights.h:104).

The tree is built on the host in numpy, as the reference builds it (the
same code, so the same float64 arithmetic and the same float32 tables),
and flattened into one (n_nodes, 16) float32 table plus each light's
root-to-leaf path. On the device, `sample` descends it with a fixed
number of masked steps, each gathering the current node's two children
by index and choosing one by relative importance; `pmf` replays a
light's stored path. The reference fetches the children with one-hot
matmuls, a TPU gather workaround; the port indexes.

`exhaustive_importance` evaluates every light's record at every shading
point, (N, L): the ExhaustiveLightSampler, the oracle the descent is held
against. It is never run on a full-size pass (at N = 524,288 and L =
2,048 one float32 temporary is 4.3 GB).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tensorclass import static_field, tensorclass

_EPS = 1e-12


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Host-side build (the reference's, copied)
# ---------------------------------------------------------------------------


def _cone_union(w1, t1, w2, t2):
    """Union of two direction cones (axis, spread angle); DirectionCone::
    Union (util/vecmath.h:1787) semantics."""
    if t1 >= np.pi or t2 >= np.pi:
        return np.array([0.0, 0.0, 1.0]), np.pi
    cos_d = float(np.clip(np.dot(w1, w2), -1.0, 1.0))
    theta_d = np.arccos(cos_d)
    # One cone inside the other?
    if min(theta_d + t2, np.pi) <= t1:
        return w1, t1
    if min(theta_d + t1, np.pi) <= t2:
        return w2, t2
    theta_o = (t1 + t2 + theta_d) / 2.0
    if theta_o >= np.pi:
        return np.array([0.0, 0.0, 1.0]), np.pi
    # Rotate w1 toward w2 by (theta_o - t1).
    theta_r = theta_o - t1
    axis = np.cross(w1, w2)
    norm = np.linalg.norm(axis)
    if norm < 1e-9:
        return w1, theta_o
    axis = axis / norm
    c, s = np.cos(theta_r), np.sin(theta_r)
    w = (
        w1 * c
        + np.cross(axis, w1) * s
        + axis * np.dot(axis, w1) * (1.0 - c)
    )
    return w / np.linalg.norm(w), theta_o


def _orientation_measure(theta_o, theta_e):
    """Solid-angle measure of a light cone's emission directions (the
    SAOH cost's orientation term, M_Omega of Conty Estevez & Kulla)."""
    theta_w = min(theta_o + theta_e, np.pi)
    s_o = np.sin(theta_o)
    return 2.0 * np.pi * (1.0 - np.cos(theta_o)) + (np.pi / 2.0) * (
        2.0 * theta_w * s_o
        - np.cos(theta_o - 2.0 * theta_w)
        + 2.0 * theta_o * s_o
        + np.cos(theta_o)
    )


class _Bounds:
    __slots__ = ("lo", "hi", "w", "theta_o", "theta_e", "phi", "two")

    def __init__(self, lo, hi, w, theta_o, theta_e, phi, two):
        self.lo, self.hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
        self.w = np.asarray(w, np.float64)
        self.theta_o, self.theta_e = float(theta_o), float(theta_e)
        self.phi = float(phi)
        self.two = bool(two)

    def union(self, o: "_Bounds") -> "_Bounds":
        w, theta_o = _cone_union(self.w, self.theta_o, o.w, o.theta_o)
        return _Bounds(
            np.minimum(self.lo, o.lo),
            np.maximum(self.hi, o.hi),
            w,
            theta_o,
            max(self.theta_e, o.theta_e),
            self.phi + o.phi,
            self.two or o.two,
        )

    def cost(self) -> float:
        ext = np.maximum(self.hi - self.lo, 0.0)
        area = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2])
        return self.phi * _orientation_measure(self.theta_o, self.theta_e) * (
            area + 1e-8
        )


def light_bounds_arrays(lights) -> list:
    """Per-positional-light _Bounds for [area | sphere | point | spot |
    projection | goniometric] lights, in light-id order (DiffuseAreaLight,
    PointLight, SpotLight, ... ::Bounds, lights.cpp)."""
    out = []
    av = _np(lights.area_verts)
    a_sc = _np(lights.area_scale)
    a_two = _np(lights.area_two_sided)
    a_area = _np(lights.area_area)
    for i in range(av.shape[0]):
        v = av[i]
        n = np.cross(v[1] - v[0], v[2] - v[0])
        nn = np.linalg.norm(n)
        n = n / nn if nn > 0 else np.array([0.0, 0.0, 1.0])
        # phi ~ scale * area * pi (the reference's estimate of the power).
        phi = float(a_sc[i]) * float(a_area[i]) * np.pi * (
            2.0 if a_two[i] else 1.0
        )
        out.append(
            _Bounds(v.min(0), v.max(0), n, 0.0, np.pi / 2.0, max(phi, 1e-9),
                    bool(a_two[i]))
        )
    # Emissive spheres: normals span the whole sphere (theta_o = pi, as a
    # point light); phi = scale * 4 pi r^2 * pi.
    qc = _np(lights.sphl_c)
    qr = _np(lights.sphl_r)
    q_sc = _np(lights.sphl_scale)
    q_two = _np(lights.sphl_two)
    for i in range(qc.shape[0]):
        r = float(qr[i])
        phi = float(q_sc[i]) * 4.0 * np.pi * r * r * np.pi * (
            2.0 if q_two[i] else 1.0
        )
        out.append(
            _Bounds(qc[i] - r, qc[i] + r, np.array([0.0, 0.0, 1.0]),
                    np.pi, np.pi / 2.0, max(phi, 1e-9), bool(q_two[i]))
        )
    pp = _np(lights.point_p)
    p_sc = _np(lights.point_scale)
    for i in range(pp.shape[0]):
        phi = 4.0 * np.pi * float(p_sc[i])
        out.append(
            _Bounds(pp[i], pp[i], np.array([0.0, 0.0, 1.0]), np.pi,
                    np.pi / 2.0, max(phi, 1e-9), False)
        )
    sp = _np(lights.spot_p)
    sdir = _np(lights.spot_dir)
    s_sc = _np(lights.spot_scale)
    s_c1 = _np(lights.spot_cos_end)
    for i in range(sp.shape[0]):
        theta_e = float(np.arccos(np.clip(s_c1[i], -1.0, 1.0)))
        solid = 2.0 * np.pi * (1.0 - float(s_c1[i]))
        phi = float(s_sc[i]) * solid
        out.append(
            _Bounds(sp[i], sp[i], sdir[i], 0.0, theta_e, max(phi, 1e-9),
                    False)
        )
    # Projection lights: a cone around the projection axis; goniometric:
    # a point-like whole sphere (ProjectionLight, GoniometricLight::Bounds).
    jp = _np(lights.proj_p)
    j_rot = _np(lights.proj_rot)
    j_tan = _np(lights.proj_tan)
    j_sc = _np(lights.proj_scale_tx)
    for i in range(jp.shape[0]):
        theta_e = float(np.arctan(float(j_tan[i]) * np.sqrt(2.0)))
        solid = 2.0 * np.pi * (1.0 - np.cos(theta_e))
        phi = float(j_sc[i].mean()) * solid
        out.append(
            _Bounds(jp[i], jp[i], j_rot[i, 2], 0.0, theta_e,
                    max(phi, 1e-9), False)
        )
    gp = _np(lights.gonio_p)
    g_sc = _np(lights.gonio_scale_tx)
    for i in range(gp.shape[0]):
        phi = 4.0 * np.pi * float(g_sc[i].mean())
        out.append(
            _Bounds(gp[i], gp[i], np.array([0.0, 0.0, 1.0]), np.pi,
                    np.pi / 2.0, max(phi, 1e-9), False)
        )
    return out


def pack_light_records(lbs) -> np.ndarray:
    """Pack per-light _Bounds into the (L, 16) record layout that
    node_importance reads (the leaf layout): the exhaustive sampler's
    table."""
    packed = np.zeros((len(lbs), 16), np.float32)
    for i, b in enumerate(lbs):
        packed[i, 0:3] = b.lo
        packed[i, 3:6] = b.hi
        packed[i, 6:9] = b.w
        packed[i, 9] = np.cos(b.theta_o)
        packed[i, 10] = np.cos(b.theta_e)
        packed[i, 11] = b.phi
        packed[i, 12] = float(i)
        packed[i, 13] = -1.0
        packed[i, 14] = 1.0 if b.two else 0.0
    return packed


@tensorclass
class LightBVH:
    """The flattened light tree and each light's descent path."""

    # Packed node record, 16 float32 columns: 0:3 lo, 3:6 hi, 6:9 axis w,
    # 9 cos_theta_o, 10 cos_theta_e, 11 phi, 12 child0 / light id, 13
    # child1 (-1: leaf), 14 two_sided, 15 pad.
    nodes: torch.Tensor  # (n_nodes, 16) float32
    # Per light, the (chosen, sibling) node ids of each level of its
    # root-to-leaf path, -1 padded.
    paths: torch.Tensor  # (L, D, 2) int32
    path_len: torch.Tensor  # (L,) int32
    max_depth: int = static_field(default=0)
    n_lights: int = static_field(default=0)

    @staticmethod
    def build(lights) -> "LightBVH | None":
        """The reference's build over the lights' tables (on the host);
        None without positional lights."""
        lbs = light_bounds_arrays(lights)
        nl = len(lbs)
        if nl == 0:
            return None
        nodes = []  # dicts: b, c0, c1, light

        def emit(b, light=-1, c0=-1, c1=-1):
            nodes.append({"b": b, "light": light, "c0": c0, "c1": c1})
            return len(nodes) - 1

        def build_rec(idxs):
            if len(idxs) == 1:
                return emit(lbs[idxs[0]], light=idxs[0])
            tot = lbs[idxs[0]]
            for i in idxs[1:]:
                tot = tot.union(lbs[i])
            me = emit(tot)
            cents = np.stack(
                [(lbs[i].lo + lbs[i].hi) * 0.5 for i in idxs]
            )
            ext = cents.max(0) - cents.min(0)
            axis = int(np.argmax(ext))
            if ext[axis] < 1e-12:
                half = len(idxs) // 2
                order = list(idxs)
            else:
                # 12-bucket SAOH sweep (lightsamplers.cpp buildBVH):
                # minimize cost(left) + cost(right).
                order = sorted(idxs, key=lambda i: (lbs[i].lo + lbs[i].hi)[
                    axis
                ])
                nb = min(12, len(order) - 1)
                best_cost, half = np.inf, len(order) // 2
                marks = [
                    max(1, min(len(order) - 1,
                               round(k * len(order) / (nb + 1))))
                    for k in range(1, nb + 1)
                ]
                for m in sorted(set(marks)):
                    bl = lbs[order[0]]
                    for i in order[1:m]:
                        bl = bl.union(lbs[i])
                    br = lbs[order[m]]
                    for i in order[m + 1:]:
                        br = br.union(lbs[i])
                    c = bl.cost() + br.cost()
                    if c < best_cost:
                        best_cost, half = c, m
            c0 = build_rec(order[:half])
            c1 = build_rec(order[half:])
            nodes[me]["c0"], nodes[me]["c1"] = c0, c1
            return me

        build_rec(list(range(nl)))

        nn = len(nodes)
        packed = np.zeros((nn, 16), np.float32)
        for i, nd in enumerate(nodes):
            b = nd["b"]
            packed[i, 0:3] = b.lo
            packed[i, 3:6] = b.hi
            packed[i, 6:9] = b.w
            packed[i, 9] = np.cos(b.theta_o)
            packed[i, 10] = np.cos(b.theta_e)
            packed[i, 11] = b.phi
            if nd["c1"] < 0:
                packed[i, 12] = float(nd["light"])
                packed[i, 13] = -1.0
            else:
                packed[i, 12] = float(nd["c0"])
                packed[i, 13] = float(nd["c1"])
            packed[i, 14] = 1.0 if b.two else 0.0

        # Root-to-leaf replay paths.
        paths = {}

        def walk(node, trail):
            nd = nodes[node]
            if nd["c1"] < 0:
                paths[nd["light"]] = list(trail)
                return
            walk(nd["c0"], trail + [(nd["c0"], nd["c1"])])
            walk(nd["c1"], trail + [(nd["c1"], nd["c0"])])

        walk(0, [])
        depth = max((len(t) for t in paths.values()), default=0)
        parr = np.full((nl, max(depth, 1), 2), -1, np.int32)
        plen = np.zeros((nl,), np.int32)
        for li, trail in paths.items():
            plen[li] = len(trail)
            for k, (c, s) in enumerate(trail):
                parr[li, k, 0] = c
                parr[li, k, 1] = s
        return LightBVH(
            nodes=torch.from_numpy(packed),
            paths=torch.from_numpy(parr),
            path_len=torch.from_numpy(plen),
            max_depth=depth,
            n_lights=nl,
        )


# ---------------------------------------------------------------------------
# Device-side importance and traversal
# ---------------------------------------------------------------------------


def _cos_sub(cos_a, sin_a, cos_b, sin_b):
    """cos(max(0, theta_a - theta_b)) from the four sines and cosines
    (LightBounds::Importance's CosSubClamped, lights.h:104)."""
    return torch.where(cos_a < cos_b, cos_a * cos_b + sin_a * sin_b, 1.0)


def _sin_sub(cos_a, sin_a, cos_b, sin_b):
    return torch.where(cos_a < cos_b, sin_a * cos_b - cos_a * sin_b, 0.0)


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def node_importance(rec, p, n_ref):
    """Importance of packed node records rec (..., 16) for shading points
    p (..., 3) with surface normals n_ref (..., 3) or None, broadcasting
    over the leading axes (LightBounds::Importance, lights.cpp)."""
    lo, hi = rec[..., 0:3], rec[..., 3:6]
    w = rec[..., 6:9]
    cos_o, cos_e = rec[..., 9], rec[..., 10]
    phi = rec[..., 11]
    two = rec[..., 14] > 0.5

    pc = 0.5 * (lo + hi)
    dvec = p - pc
    d2 = torch.sum(dvec * dvec, dim=-1)
    diag = hi - lo
    r2 = 0.25 * torch.sum(diag * diag, dim=-1)
    d2c = torch.maximum(d2, r2)  # do not explode inside the bounds
    wi = dvec / torch.sqrt(torch.clamp(d2, min=_EPS))[..., None]

    cos_w = torch.sum(w * wi, dim=-1)
    cos_w = torch.where(two, torch.abs(cos_w), cos_w)
    sin_w = _safe_sqrt(1.0 - cos_w * cos_w)

    sin2_u = torch.clamp(r2 / torch.clamp(d2, min=_EPS), max=1.0)
    sin_u = torch.sqrt(sin2_u)
    cos_u = _safe_sqrt(1.0 - sin2_u)

    sin_o = _safe_sqrt(1.0 - cos_o * cos_o)
    cos_wo = _cos_sub(cos_w, sin_w, cos_o, sin_o)
    sin_wo = _sin_sub(cos_w, sin_w, cos_o, sin_o)
    cos_x = _cos_sub(cos_wo, sin_wo, cos_u, sin_u)

    imp = torch.where(cos_x > cos_e, phi * cos_x / d2c, 0.0)
    if n_ref is not None:
        cos_i = torch.abs(torch.sum(wi * n_ref, dim=-1))
        sin_i = _safe_sqrt(1.0 - cos_i * cos_i)
        # All-zero normals mean no surface orientation (a point in a
        # medium, or the camera): no incident-cosine factor.
        has_n = torch.sum(n_ref * n_ref, dim=-1) > 0.5
        imp = imp * torch.where(has_n, _cos_sub(cos_i, sin_i, cos_u, sin_u),
                                1.0)
    return torch.clamp(imp, min=0.0)


def exhaustive_importance(recs, p, n_ref):
    """(N, L) importance of every light record at every shading point."""
    return node_importance(recs[None], p[:, None],
                           None if n_ref is None else n_ref[:, None])


def _children(nodes, rec):
    """The records of a node batch's two children, stacked: (2, N, 16)
    (child ids clamped at 0 for leaves, as the reference clamps)."""
    c = torch.clamp(torch.round(rec[:, 12:14]).long(), min=0)
    return nodes[c.T], c


def sample(bvh: LightBVH, p, n_ref, u):
    """Stochastic descent: (light id (N,) int64, pmf (N,)); id -1 and pmf
    0 where every branch's importance vanishes (BVHLightSampler::Sample,
    lightsamplers.h:260-320)."""
    n = p.shape[0]
    dev = p.device
    if bvh.n_lights == 1:
        return (torch.zeros((n,), dtype=torch.int64, device=dev),
                torch.ones((n,), dtype=p.dtype, device=dev))
    nodes = bvh.nodes
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    pmf = torch.ones((n,), dtype=p.dtype, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    dead = torch.zeros((n,), dtype=torch.bool, device=dev)
    for _ in range(bvh.max_depth + 1):
        rec = nodes[node]
        is_leaf = rec[:, 13] < 0.0
        kids, c = _children(nodes, rec)
        imp = node_importance(kids, p, n_ref)
        i0 = imp[0]
        tot = i0 + imp[1]
        q0 = torch.where(tot > 0.0, i0 / torch.clamp(tot, min=_EPS), 0.0)
        go0 = u < q0
        # Remap u to keep its stratification (SampleDiscrete's remap).
        u_next = torch.where(
            go0,
            u / torch.clamp(q0, min=_EPS),
            (u - q0) / torch.clamp(1.0 - q0, min=_EPS),
        )
        u_next = torch.clamp(u_next, 0.0, 1.0 - 1e-7)
        q = torch.where(go0, q0, 1.0 - q0)
        nxt = torch.where(go0, c[:, 0], c[:, 1])
        act = ~done & ~dead & ~is_leaf
        dead = dead | (act & (tot <= 0.0))
        step = act & (tot > 0.0)
        node = torch.where(step, nxt, node)
        u = torch.where(step, u_next, u)
        pmf = torch.where(step, pmf * q, pmf)
        done = done | (~dead & is_leaf)
    light = torch.round(nodes[node][:, 12]).long()
    ok = done & ~dead
    return torch.where(ok, light, -1), torch.where(ok, pmf, 0.0)


def pmf(bvh: LightBVH, p, n_ref, light_idx):
    """Probability that `sample` picks light_idx at p: the product of the
    branch probabilities along the light's stored path
    (BVHLightSampler::PMF, lightsamplers.h:300-320)."""
    n = p.shape[0]
    if bvh.n_lights == 1:
        return torch.ones((n,), dtype=p.dtype, device=p.device)
    li = torch.clamp(light_idx, 0, bvh.n_lights - 1).long()
    path = bvh.paths[li].long()  # (N, D, 2)
    plen = bvh.path_len[li]
    prob = torch.ones((n,), dtype=p.dtype, device=p.device)
    for k in range(bvh.paths.shape[1]):
        # The chosen node and its sibling, stacked: (2, N, 16).
        rows = bvh.nodes[torch.clamp(path[:, k], min=0).T]
        imp = node_importance(rows, p, n_ref)
        ic = imp[0]
        tot = ic + imp[1]
        q = torch.where(tot > 0.0, ic / torch.clamp(tot, min=_EPS), 0.0)
        prob = torch.where(k < plen, prob * q, prob)
    return torch.where(light_idx >= 0, prob, 0.0)
