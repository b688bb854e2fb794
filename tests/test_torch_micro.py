"""The card micro-benchmarks (pbrt_tpu_torch/micro/) against the TPU probes
they port (scripts/micro/).

Each variant is one probe kernel in one mode at reduced constants (grid
2-3, 8-136 iterations): the 25 of the probes, micro_mosaic's reduce and
cond on an x whose block max crosses their 1e30 (the probe's ones never
do), and micro_entry on a table whose triangles its rays hit in every
entry (the probe's table gives them none). The
port's plain PyTorch version runs here on the CPU; the probe's answer
comes from tests/data/torch_port/micro.npz, made by
scripts/make_torch_port_golden_micro.py from the probe's own kernel in
Pallas interpret mode, beside a digest of its inputs and constants that
each case checks first.

Interpret mode runs on XLA's CPU backend, which contracts a multiply
followed by an add into one FMA (one rounding). The kernels round each
operation (they are built with --fmad=false), and so do the plain
versions as shipped; these write every such multiply-add through
`pbrt_tpu_torch.micro.madd`, which the comparison with the probe replaces
by an FMA. The kernels are held against the shipped plain versions on
the card. Tolerances:

- bit-equal (NaN equal to NaN) wherever no float sum spans lanes:
  micro_pairs (its sums are of 0/1 values, its gather loop runs in order),
  micro_mosaic (cond's sum of x is exact: of ones, or of ones beside one
  lane whose ulp is larger than their sum), micro_mosaic2 and micro_entry
  (its lane sums select at most one lane, which is exact);
- rtol 2e-6 for micro_dyn's output, a sum of 128 or 1024 lanes (and
  matmul_small's products): the plain version sums by a fixed halving
  tree, the reference in XLA's order. At mt35 the reference's sum is
  1.4e-6 from the float64 sum of the same terms, the tree's 2e-8;
- micro_dyn's smemread reads scalar scratch the probe never writes, so
  the probe's answer is undefined (garbage in interpret mode); the port's
  scratch starts at zero, and its answer is held to 128 * (grid - 1).
  micro_pairs's outputs are compared only where the probe writes them.

micro_entry's probe output is its loop's acc plus group 0's t, and in
loads_only, blocks_only, mt_only and no_write that t is never written and
stays 1e30: there the comparison with the probe checks only the saturated
output (1e30 or inf), not acc. The port also returns the loop's own acc;
the `cuda` cases and chip_smoke.py hold it bit-equal between kernel and
plain version, and on `micro_entry.hits_inputs` it is finite.

The `cuda`-marked cases hold each kernel against its plain version on the
card (bit-equal, NaN equal) and skip without one. On a machine with a
card, from the repository root:

    python3 -m pytest -o addopts="" --noconftest -p no:cacheprovider -q \
        tests/test_torch_micro.py
"""

import os

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.core.floats import fma
from pbrt_tpu_torch.micro import (bits_equal, micro_dyn, micro_entry,
                                  micro_mosaic, micro_mosaic2, micro_pairs)

from .torch_port_helpers import inputs_digest

MAINS = (micro_pairs, micro_mosaic, micro_mosaic2, micro_dyn, micro_entry)
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port",
                      "micro.npz")

# The reduced constants of scripts/make_torch_port_golden_micro.py.
LOOP = dict(grid=2, n_it=8)
DENSE = dict(grid=2, n_it=8)
MOSAIC2 = dict(grid=3, n_it=16)
DYN = dict(grid=3, n_it=32)
ENTRY = dict(grid=3, n_ent=32)
ENTRY_LONG = dict(grid=3, n_ent=136)

VARIANTS = (
    [("pairs", None)]
    + [("loop", m) for m in micro_mosaic.LOOP_MODES]
    + [("loop_cross", m) for m in ("reduce", "cond")]
    + [("dense", None)]
    + [("mosaic2", mr) for mr in (("nocond", 12), ("cond", 12), ("cond", 1),
                                   ("cond", 4), ("cond", 36))]
    + [("dyn", m) for m in micro_dyn.MODES]
    + [("entry", (m, ENTRY, False)) for m in micro_entry.MODES]
    + [("entry", ("full", ENTRY_LONG, False))]
)
# micro_entry's modes also run on a table whose triangles its rays hit
# in every entry (the probe's table gives them none), over 136 entries.
HITS_MODES = ("mt_only", "no_write", "full", "while")
VARIANTS += [("entry", (m, ENTRY_LONG, True)) for m in HITS_MODES]

# Variants whose answer is a float sum across lanes.
SUMMED = {f"dyn_{m}" for m in micro_dyn.MODES}


def digest(consts: dict, arrays: dict) -> str:
    """The digest of a variant's constants and input arrays."""
    return inputs_digest({k: np.asarray(v) for k, v in consts.items()},
                         arrays)


def _name(kind, arg):
    if kind in ("pairs", "dense"):
        return kind
    if kind == "mosaic2":
        return f"mosaic2_{arg[0]}_r{arg[1]}"
    if kind == "loop_cross":
        return f"loop_{arg}_cross"
    if kind == "entry":
        hits = "_hits" if arg[2] else ""
        return f"entry_{arg[0]}_n{arg[1]['n_ent']}{hits}"
    return f"{kind}_{arg}"


def run_variant(kind, arg, device, plain=False):
    """(key, constants, numpy inputs, outputs) of one variant: the wrapper
    on `device`, or its plain version with plain=True."""
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    if kind == "pairs":
        live, rays = micro_pairs.inputs()
        fn = micro_pairs.micro_pairs_ref if plain else micro_pairs.micro_pairs
        lst, gat, meta = fn(t(live), t(rays))
        return ({}, {"live": live, "rays": rays},
                {"o_list": lst, "o_gather": gat, "o_meta": meta})
    if kind == "loop":
        x, _ = micro_mosaic.inputs()
        fn = micro_mosaic.loop_ref if plain else micro_mosaic.loop
        return (dict(LOOP, mode=arg), {"x": x},
                {"out": fn(t(x), mode=arg, **LOOP)})
    if kind == "loop_cross":
        x = micro_mosaic.crossing_inputs(LOOP["n_it"])
        fn = micro_mosaic.loop_ref if plain else micro_mosaic.loop
        return (dict(LOOP, mode=arg), {"x": x},
                {"out": fn(t(x), mode=arg, **LOOP)})
    if kind == "dense":
        a, b = micro_mosaic.inputs()
        fn = micro_mosaic.dense_ref if plain else micro_mosaic.dense
        return DENSE, {"a": a, "b": b}, {"out": fn(t(a), t(b), **DENSE)}
    if kind == "mosaic2":
        mode, reps = arg
        x, tab = micro_mosaic2.inputs()
        fn = (micro_mosaic2.micro_mosaic2_ref if plain
              else micro_mosaic2.micro_mosaic2)
        return (dict(MOSAIC2, mode=mode, body_reps=reps),
                {"x": x, "tab": tab},
                {"out": fn(t(x), t(tab), mode=mode, body_reps=reps,
                           **MOSAIC2)})
    if kind == "dyn":
        tab = micro_dyn.inputs()
        fn = micro_dyn.micro_dyn_ref if plain else micro_dyn.micro_dyn
        return (dict(DYN, mode=arg), {"tab": tab},
                {"out": fn(t(tab), mode=arg, **DYN)})
    mode, consts, hits = arg
    tri = micro_entry.hits_inputs() if hits else micro_entry.inputs()
    fn = micro_entry.micro_entry_ref if plain else micro_entry.micro_entry
    out, scratch, acc = fn(t(tri), mode=mode, with_scratch=True, **consts)
    return (dict(consts, mode=mode), {"tri": tri},
            {"out": out, "scratch": scratch, "acc": acc})


def golden(key: str, consts: dict, arrays: dict) -> dict:
    prefix = f"{key}/"
    with np.load(GOLDEN) as z:
        assert prefix + "digest" in z.files, (
            f"{key}: no golden; rerun scripts/make_torch_port_golden_micro.py")
        assert str(z[prefix + "digest"]) == digest(consts, arrays), (
            f"{key}: the golden's inputs differ from the port's; rerun "
            "scripts/make_torch_port_golden_micro.py")
        return {k[len(prefix):]: z[k] for k in z.files
                if k.startswith(prefix) and k != prefix + "digest"}


def assert_bits(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert bits_equal(torch.from_numpy(np.ascontiguousarray(got)),
                      torch.from_numpy(np.ascontiguousarray(want))), (
        what, got.ravel()[:8], want.ravel()[:8])


@pytest.mark.parametrize("kind,arg", VARIANTS,
                         ids=[_name(k, a) for k, a in VARIANTS])
def test_plain_matches_probe(kind, arg, monkeypatch):
    # Interpret mode runs on XLA's CPU backend, which contracts each
    # multiply-add the plain versions write as `madd` into an FMA; the
    # kernels round twice (--fmad=false), as the shipped plain versions do.
    for module in MAINS:
        monkeypatch.setattr(module, "madd", fma)
    key = _name(kind, arg)
    consts, arrays, outs = run_variant(kind, arg, torch.device("cpu"))
    got = {k: v.numpy() for k, v in outs.items()}
    want = golden(key, consts, arrays)
    if kind == "pairs":
        n = int(want["o_meta"][0, 0])
        assert n == int(arrays["live"].sum())
        assert_bits(got["o_meta"], want["o_meta"], key)
        assert_bits(got["o_list"][:, 0], want["o_list"][:, 0], key)
        assert_bits(got["o_gather"][:, 0], want["o_gather"][:, 0], key)
        assert got["o_gather"][n % 8, 1] == want["o_gather"][n % 8, 1] == 123
        return
    if key == "dyn_smemread":
        # The probe reads scratch it never wrote; the port's starts at 0.
        assert got["out"].item() == 128.0 * (DYN["grid"] - 1)
        return
    # The probe's outputs only: it has no acc of its own (see the head).
    for name in want:
        if key in SUMMED and name == "out":
            np.testing.assert_allclose(got[name], want[name], rtol=2e-6)
        else:
            assert_bits(got[name], want[name], f"{key}/{name}")


def test_smemread_golden_is_unwritten_scratch():
    """The probe's smemread answer is not the zero-scratch one: the
    departure the test above states is real."""
    consts, arrays, _ = run_variant("dyn", "smemread", torch.device("cpu"))
    want = golden("dyn_smemread", consts, arrays)["out"].item()
    assert want != 128.0 * (DYN["grid"] - 1)


def test_hits_inputs_give_every_entry_a_hit():
    """hits_inputs holds the crossed triangle whole at every entry's rows,
    and mt_only's acc over its 13 lanes' entries is finite at the probe's
    grid, where the probe's table makes it inf."""
    tri = micro_entry.hits_inputs()
    crossed = np.asarray(micro_entry._CROSSED, np.float32)
    for c in range(900):
        want = crossed.copy()
        want[9] += c % 13
        np.testing.assert_array_equal(tri[c:c + 13, c % 13], want)
    # Entries 0-12 visit c = 0, 7, ..., 84: each of the 13 lanes once.
    consts = dict(grid=micro_entry.GRID, n_ent=13)
    _, _, acc = micro_entry.micro_entry_ref(
        torch.from_numpy(tri), mode="mt_only", with_scratch=True, **consts)
    assert torch.isfinite(acc).all() and (acc > 0).all()
    _, _, acc = micro_entry.micro_entry_ref(
        torch.from_numpy(micro_entry.inputs()), mode="mt_only",
        with_scratch=True, **consts)
    assert torch.isinf(acc).all()


WRAPPERS = {
    "pairs": ("pairs", None, micro_pairs.STATS),
    "loop": ("loop", "reduce", micro_mosaic.LOOP_STATS),
    "dense": ("dense", None, micro_mosaic.DENSE_STATS),
    "mosaic2": ("mosaic2", ("cond", 4), micro_mosaic2.STATS),
    "dyn": ("dyn", "mt35", micro_dyn.STATS),
    "entry": ("entry", ("full", ENTRY, True), micro_entry.STATS),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cpu_tensor_runs_plain_version(name):
    """A CPU tensor takes the plain version and counts no launch."""
    kind, arg, stats = WRAPPERS[name]
    stats.reset()
    _, _, got = run_variant(kind, arg, torch.device("cpu"))
    _, _, want = run_variant(kind, arg, torch.device("cpu"), plain=True)
    assert stats.launches == 0
    for k in want:
        assert bits_equal(got[k], want[k]), k


@pytest.mark.parametrize("call", [
    lambda: micro_dyn.micro_dyn(torch.zeros(1024, 128), mode="bogus"),
    lambda: micro_mosaic2.micro_mosaic2(torch.zeros(8, 128),
                                        torch.zeros(2048, 128), mode="cond",
                                        n_it=4, body_reps=5),
    lambda: micro_entry.micro_entry(torch.zeros(1024, 64), mode="full"),
    lambda: micro_mosaic.loop(torch.zeros(8, 128), mode="cond", n_it=-1),
    lambda: micro_mosaic2.micro_mosaic2(torch.zeros(8, 128),
                                        torch.zeros(2048, 128),
                                        mode="nocond", n_it=4, body_reps=4),
], ids=["mode", "body_reps", "shape", "n_it", "nocond_body_reps"])
def test_wrappers_refuse_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("module", MAINS, ids=[m.__name__.split(".")[-1]
                                               for m in MAINS])
def test_main_refuses_a_machine_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit) as exc:
        module.main([])
    assert "--device cpu" in str(exc.value)


def test_main_on_cpu_prints_the_probe_lines(capsys):
    micro_pairs.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cpu")
    assert lines[1] == "device=cpu: OK count=35"
    assert lines[2].startswith("pairs") and lines[2].endswith(" ms")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the micro kernels run only on the "
                    "card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,arg", VARIANTS,
                         ids=[_name(k, a) for k, a in VARIANTS])
def test_kernel_matches_plain_on_card(card, kind, arg):
    _, _, got = run_variant(kind, arg, card)
    _, _, want = run_variant(kind, arg, card, plain=True)
    torch.cuda.synchronize()
    for k in want:
        assert bits_equal(got[k].cpu(), want[k].cpu()), (_name(kind, arg), k)
