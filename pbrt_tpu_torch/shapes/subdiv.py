"""Loop subdivision surfaces (port of pbrt_tpu/shapes/subdiv.py, host
numpy, the reference's code).

LoopSubdivide (mesh.cpp and the loopsubdiv shape of shapes.cpp in the
reference renderer): a triangle mesh refined with Loop's scheme, then
rendered as plain triangles. Interior even vertices take Loop's beta(n),
boundary vertices the 1/8-6/8-1/8 curve mask, and odd (edge) vertices
3/8-3/8-1/8-1/8.
"""

from __future__ import annotations

import numpy as np


def _beta(n):
    # Loop's original beta (mesh.cpp LoopSubdivide beta()).
    return np.where(
        n == 3, 3.0 / 16.0,
        (1.0 / n) * (
            5.0 / 8.0
            - (3.0 / 8.0 + 0.25 * np.cos(2.0 * np.pi / n)) ** 2
        ),
    )


def loop_subdivide(verts, faces, levels: int = 1):
    """One or more Loop subdivision steps.

    verts: (V, 3) float; faces: (F, 3) int. Returns (verts', faces')."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    for _ in range(levels):
        v, f = _subdivide_once(v, f)
    return v.astype(np.float32), f.astype(np.int32)


def _subdivide_once(v, f):
    nv = v.shape[0]
    # Edge table: undirected edges -> id, with the two adjacent faces'
    # opposite vertices for the odd-vertex mask.
    edges = {}
    opp = {}
    for fi, (a, b, c) in enumerate(f):
        for (p, q, o) in ((a, b, c), (b, c, a), (c, a, b)):
            key = (min(p, q), max(p, q))
            if key not in edges:
                edges[key] = len(edges)
                opp[key] = []
            opp[key].append(o)
    edge_ids = {k: nv + i for i, (k, _) in enumerate(
        sorted(edges.items(), key=lambda kv: kv[1])
    )}

    # Odd (new edge) vertices.
    new_pts = np.zeros((len(edges), 3))
    boundary_edges = set()
    for key, eid in edge_ids.items():
        a, b = key
        os_ = opp[key]
        if len(os_) == 2:
            new_pts[eid - nv] = (
                0.375 * (v[a] + v[b]) + 0.125 * (v[os_[0]] + v[os_[1]])
            )
        else:  # boundary edge
            new_pts[eid - nv] = 0.5 * (v[a] + v[b])
            boundary_edges.add(key)

    # Even (old) vertices: neighbor rings.
    neighbors = [set() for _ in range(nv)]
    for (a, b) in edges:
        neighbors[a].add(b)
        neighbors[b].add(a)
    boundary_nbrs = [set() for _ in range(nv)]
    for (a, b) in boundary_edges:
        boundary_nbrs[a].add(b)
        boundary_nbrs[b].add(a)
    new_even = np.zeros_like(v)
    for i in range(nv):
        if boundary_nbrs[i]:
            bs = list(boundary_nbrs[i])
            if len(bs) == 2:
                new_even[i] = 0.75 * v[i] + 0.125 * (v[bs[0]] + v[bs[1]])
            else:  # corner / non-manifold boundary: keep
                new_even[i] = v[i]
        else:
            ring = list(neighbors[i])
            n = len(ring)
            if n == 0:
                new_even[i] = v[i]
                continue
            b = float(_beta(np.asarray(n, np.float64)))
            new_even[i] = (1.0 - n * b) * v[i] + b * v[ring].sum(axis=0)

    out_v = np.concatenate([new_even, new_pts])
    out_f = []
    for (a, b, c) in f:
        ab = edge_ids[(min(a, b), max(a, b))]
        bc = edge_ids[(min(b, c), max(b, c))]
        ca = edge_ids[(min(c, a), max(c, a))]
        out_f.extend([(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)])
    return out_v, np.asarray(out_f, np.int64)
