#!/usr/bin/env python
"""Run the TPU probes of scripts/micro/ in Pallas interpret mode at reduced
constants and commit their answers, for tests/test_torch_micro.py.

Each variant is one probe kernel in one mode: the probe's own `kern`,
`loop_kernel` or `dense_kernel`, passed to `pl.pallas_call` with the
probe's specs and interpret=True, on the probe's inputs. The script sets
the probes' module constants (N_IT, N_ENT) in its own process and edits
none of their files. Every variant is stored under "<variant>/<output>"
beside "<variant>/digest", a digest of its inputs and constants that the
test rebuilds from the port's inputs and checks before it compares
(tests/torch_port_helpers.py::inputs_digest).

micro_entry's ray and accumulator scratches are passed as outputs in
place of scratch memory (same shapes, same order of references), so the
golden also holds the last program's accumulator.

It writes tests/data/torch_port/micro.npz. Usage, from the repository
root (about a minute on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_port_golden_micro.py
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts", "micro"))

OUT = os.path.join(ROOT, "tests", "data", "torch_port", "micro.npz")

# Reduced constants (the probes' full ones are in pbrt_tpu_torch/micro/).
# micro_entry at 136 entries revisits groups 0-7, so their best t is
# tested against an earlier hit. The probe's own table gives its rays no
# hit at all; the "hits" runs feed the same kernel
# pbrt_tpu_torch/micro/micro_entry.py::hits_inputs, whose triangles the
# rays hit in every entry. The "cross" runs feed loop_kernel the x of
# micro_mosaic.py::crossing_inputs, under which reduce and cond take their
# branch (the probe's ones never do).
LOOP = dict(grid=2, n_it=8)
DENSE = dict(grid=2, n_it=8)
MOSAIC2 = dict(grid=3, n_it=16)
MOSAIC2_RUNS = (("nocond", 12), ("cond", 12), ("cond", 1), ("cond", 4),
                ("cond", 36))
DYN = dict(grid=3, n_it=32)
ENTRY = dict(grid=3, n_ent=32)
ENTRY_LONG = dict(grid=3, n_ent=136)


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    import micro_dyn
    import micro_entry
    import micro_mosaic
    import micro_mosaic2
    import micro_pairs
    # Importing the probes points JAX's compilation cache at a fixed
    # directory outside this tree; this script keeps no cache.
    jax.config.update("jax_compilation_cache_dir", None)
    from pbrt_tpu_torch.micro import micro_dyn as p_dyn
    from pbrt_tpu_torch.micro import micro_entry as p_entry
    from pbrt_tpu_torch.micro import micro_mosaic as p_mosaic
    from pbrt_tpu_torch.micro import micro_mosaic2 as p_mosaic2
    from pbrt_tpu_torch.micro import micro_pairs as p_pairs
    from tests.test_torch_micro import HITS_MODES, digest

    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    out = {}

    def put(key, consts, arrays, outs):
        out[f"{key}/digest"] = np.asarray(digest(consts, arrays))
        for name, a in outs.items():
            out[f"{key}/{name}"] = np.asarray(a)
        print(key, {n: np.asarray(a).ravel()[:3] for n, a in outs.items()},
              flush=True)

    # micro_pairs: one program.
    live, rays = p_pairs.inputs()
    f = pl.pallas_call(
        micro_pairs.kern, in_specs=[vmem] * 2, out_specs=[vmem] * 3,
        out_shape=[jax.ShapeDtypeStruct((128, 128), jnp.float32),
                   jax.ShapeDtypeStruct((8, 128), jnp.float32),
                   jax.ShapeDtypeStruct((1, 1), jnp.float32)],
        interpret=True)
    lst, gat, meta = f(jnp.asarray(live), jnp.asarray(rays))
    put("pairs", {}, {"live": live, "rays": rays},
        {"o_list": lst, "o_gather": gat, "o_meta": meta})

    # micro_mosaic: loop_kernel per mode, then dense_kernel.
    x, y = p_mosaic.inputs()
    x_cross = p_mosaic.crossing_inputs(LOOP["n_it"])
    micro_mosaic.N_IT = LOOP["n_it"]
    runs = ([(m, x, "") for m in p_mosaic.LOOP_MODES]
            + [(m, x_cross, "_cross") for m in ("reduce", "cond")])
    for mode, x_in, suffix in runs:
        f = pl.pallas_call(
            functools.partial(micro_mosaic.loop_kernel, mode=mode),
            grid=(LOOP["grid"],), in_specs=[vmem],
            out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            interpret=True)
        put(f"loop_{mode}{suffix}", dict(LOOP, mode=mode), {"x": x_in},
            {"out": f(jnp.asarray(x_in))})
    f = pl.pallas_call(
        functools.partial(micro_mosaic.dense_kernel, n_it=DENSE["n_it"]),
        grid=(DENSE["grid"],), in_specs=[vmem] * 2,
        out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)
    put("dense", DENSE, {"a": x, "b": y},
        {"out": f(jnp.asarray(x), jnp.asarray(y))})

    # micro_mosaic2: nocond and cond at 12 reps, cond at 1, 4 and 36.
    x2, tab2 = p_mosaic2.inputs()
    for mode, reps in MOSAIC2_RUNS:
        f = pl.pallas_call(
            functools.partial(micro_mosaic2.kern, n_it=MOSAIC2["n_it"],
                              mode=mode, body_reps=reps),
            grid=(MOSAIC2["grid"],), in_specs=[vmem] * 2,
            out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            interpret=True)
        put(f"mosaic2_{mode}_r{reps}", dict(MOSAIC2, mode=mode,
                                            body_reps=reps),
            {"x": x2, "tab": tab2},
            {"out": f(jnp.asarray(x2), jnp.asarray(tab2))})

    # micro_dyn: the nine modes.
    tab = p_dyn.inputs()
    micro_dyn.N_IT = DYN["n_it"]
    for mode in p_dyn.MODES:
        f = pl.pallas_call(
            functools.partial(micro_dyn.kern, mode=mode),
            grid=(DYN["grid"],), in_specs=[vmem],
            out_specs=pl.BlockSpec((1, 1), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
            scratch_shapes=[pltpu.VMEM((1024, 128), jnp.float32),
                            pltpu.SMEM((1024,), jnp.int32)],
            interpret=True)
        put(f"dyn_{mode}", dict(DYN, mode=mode), {"tab": tab},
            {"out": f(jnp.asarray(tab))})

    # micro_entry: the six modes, and full over 136 entries.
    tri = p_entry.inputs()
    runs = ([(m, ENTRY, tri, "") for m in p_entry.MODES]
            + [("full", ENTRY_LONG, tri, "")]
            + [(m, ENTRY_LONG, p_entry.hits_inputs(), "_hits")
               for m in HITS_MODES])
    for mode, consts, table, suffix in runs:
        micro_entry.N_ENT = consts["n_ent"]
        whole = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
        f = pl.pallas_call(
            functools.partial(micro_entry.kern, mode=mode),
            grid=(consts["grid"],), in_specs=[vmem],
            out_specs=[whole((8, 1), lambda i: (0, 0)),
                       whole((128, 8, 8), lambda i: (0, 0, 0)),
                       whole((128, 8, 16), lambda i: (0, 0, 0))],
            out_shape=[jax.ShapeDtypeStruct((8, 1), jnp.float32),
                       jax.ShapeDtypeStruct((128, 8, 8), jnp.float32),
                       jax.ShapeDtypeStruct((128, 8, 16), jnp.float32)],
            interpret=True)
        o, _, acc_t3 = f(jnp.asarray(table))
        put(f"entry_{mode}_n{consts['n_ent']}{suffix}",
            dict(consts, mode=mode), {"tri": table},
            {"out": o, "scratch": acc_t3})

    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays", flush=True)


if __name__ == "__main__":
    main()
