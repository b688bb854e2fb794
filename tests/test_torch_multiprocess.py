"""The port's multi-process render and training step over torch.distributed
(pbrt_tpu_torch/parallel/multiprocess.py, mp_worker.py) with gloo on CPU
processes, with the cases of tests/test_multiprocess.py at its gates: the
image is bit-equal across process counts (1, 2 and 4 processes of 2 mesh
entries each), the gradients are identical on every rank of a layout
and within rtol 2e-4 / atol 1e-7 of one process's (the partial sums
group differently), and the loss within rtol 1e-5.

And against the reference's own render_multiprocess and
train_step_multiprocess with the same inputs (tests/data/torch_port/
parallel16.npz, scripts/make_torch_port_golden_parallel.py: 16x16,
depth 3, 8 lanes, 4 spp, a flat 0.25 target, on its 8-device CPU mesh):
one process's image has at least 99% of its values within rtol 1e-3 /
atol 1e-5, its loss is within rtol 1e-3 and its gradients within 1e-3
of each tensor's largest entry.

Every layout is spawned once for the module (each process renders and
takes the training step, one CPU thread each), at most four processes at
a time: the 1- and 2-process layouts and the failing rank together,
then the 4-process layout; each group has its own time limit, and a
rank that fails fails the spawn.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from .torch_port_helpers import share_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port", "parallel16.npz")
GROUPS = ((1, 2), (4,))  # the layouts started together
TIMEOUT_S = 120


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(nprocs, out, local_devices=2, extra=()):
    """Start one layout's processes; returns them with their out prefix."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "pbrt_tpu_torch.parallel.mp_worker",
             "--coordinator", f"127.0.0.1:{port}", "--nprocs", str(nprocs),
             "--pid", str(pid), "--local-devices", str(local_devices),
             "--mode", "both", "--res", "16", "--spp", "4",
             "--n-spectrum", "8", "--device", "cpu", "--timeout", "120",
             "--out", out, *extra],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        for pid in range(nprocs)
    ]
    return procs, out


def _finish(procs, out):
    """Wait for a layout's processes for TIMEOUT_S; kill them all if it
    passes. Returns [(returncode, stderr)]."""
    deadline = time.monotonic() + TIMEOUT_S
    outs = []
    for p in procs:
        try:
            _, stderr = p.communicate(timeout=max(deadline - time.monotonic(),
                                                  1.0))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"mp worker timed out ({out})")
        outs.append((p.returncode, stderr.decode()[-2000:]))
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{nprocs: [each rank's npz]} of the three layouts, and the return
    codes and errors of a layout whose one rank names an unknown
    backend."""
    tmp = tmp_path_factory.mktemp("mp")
    bad = _start(1, str(tmp / "bad"), extra=("--backend", "no-such-backend"))
    every = list(bad[0])
    out = {}
    try:
        for group in GROUPS:
            started = {n: _start(n, str(tmp / f"r{n}")) for n in group}
            every += [p for procs, _ in started.values() for p in procs]
            for n, (procs, prefix) in started.items():
                for rc, stderr in _finish(procs, prefix):
                    assert rc == 0, stderr
                out[n] = [dict(np.load(f"{prefix}.{pid}.npz"))
                          for pid in range(n)]
            if "bad" not in out:
                out["bad"] = _finish(*bad)
    finally:
        for p in every:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.parametrize("nprocs", [2])
def test_render_bitwise_across_process_counts(runs, nprocs):
    base = runs[1][0]
    assert base["img"].shape == (16, 16, 3) and np.isfinite(base["img"]).all()
    assert base["img"].mean() > 0
    for shard in runs[nprocs]:
        np.testing.assert_array_equal(shard["img"], base["img"])
    assert runs[nprocs][0]["ndev"] == nprocs * 2
    assert str(runs[nprocs][0]["backend"]) == "gloo"


def test_render_four_processes_bitwise(runs):
    base = runs[1][0]
    for shard in runs[4]:
        np.testing.assert_array_equal(shard["img"], base["img"])
    assert runs[4][0]["ndev"] == 8


@pytest.mark.parametrize("nprocs", [2, 4])
def test_gradient_psum_across_processes(runs, nprocs):
    base, multi = runs[1][0], runs[nprocs]
    # Identical on every process of one layout; allclose across layouts
    # (the partial sums group by shard).
    for name in ("albedo_coeffs", "area_scale", "loss"):
        for rank in multi[1:]:
            np.testing.assert_array_equal(rank[name], multi[0][name])
    assert np.abs(base["albedo_coeffs"]).max() > 0
    for name in ("albedo_coeffs", "area_scale"):
        np.testing.assert_allclose(multi[0][name], base[name], rtol=2e-4,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_allclose(multi[0]["loss"], base["loss"], rtol=1e-5)


def test_a_failing_rank_fails_the_run(runs):
    """An exception in a worker (here: an unknown backend) ends it with a
    non-zero exit code and its traceback, never 0."""
    ((rc, stderr),) = runs["bad"]
    assert rc != 0
    assert "no-such-backend" in stderr or "backend" in stderr.lower(), stderr


def test_one_process_matches_the_reference(runs):
    """render_multiprocess and train_step_multiprocess against the
    reference's, on the same inputs."""
    got, want = runs[1][0], np.load(GOLDEN)
    assert int(want["mp_spp"]) == 4 and int(want["n_spectrum"]) == 8
    share, n_off = share_close(got["img"], want["mp_img"], rtol=1e-3,
                               atol=1e-5)
    assert share >= 0.99, (share, n_off)
    np.testing.assert_allclose(got["img"].mean(), want["mp_img"].mean(),
                               rtol=1e-3)
    np.testing.assert_allclose(float(got["loss"]), float(want["mp_loss"]),
                               rtol=1e-3)
    for name in ("albedo_coeffs", "area_scale"):
        ref = want[f"mp_{name}"]
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(got[name], ref, rtol=0, atol=1e-3 * scale,
                                   err_msg=name)
