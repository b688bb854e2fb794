"""The port's render CLI (pbrt_tpu_torch/tools/pbrt_render.py) on the CPU.

- The image, the GBuffer and spectral channels and the --debugstart
  record of tests/test_tools.py's scenes against the JAX package's CLI
  (tests/data/torch_port/cli16.npz, scripts/make_torch_port_golden_cli.py):
  >= 99% of values within rtol 1e-3 / atol 1e-5 and the mean within rtol
  1e-3; MaterialId and PrimId exactly equal. The normals are held on the
  pixels whose every sample hits a surface: on a miss the reference
  writes the facing normal of triangle 0 (its gather at prim 0 for prim
  -1) and the port writes 0, as pbrt-v4's VisibleSurface leaves a miss
  (ROADMAP Queue 3); a pixel no sample hits reads 0 in the port. The
  record within rtol 1e-4, and two runs bit-equal.
- The CLI's EXR equals render_file's image at the same arguments and
  carries the reference's metadata keys; every other flag of the
  reference CLI (maxdepth, pixel jitter, PNG out, the MSE harness,
  --stats, the tev client, the interactive viewer, the function
  integrator's dispatch) does what the reference's does.
- --format, --toply and --upgrade print byte for byte what the
  reference's format_file prints, and write the same PLY bytes.
- --device cuda without a card raises RuntimeError and renders nothing.
"""

import contextlib
import io
import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from pbrt_tpu.tools import format_scene as jax_format
from pbrt_tpu_torch.films.gbuffer import render_aovs
from pbrt_tpu_torch.io.image import read_exr, read_png, write_exr
from pbrt_tpu_torch.io.parser import load_pbrt
from pbrt_tpu_torch.render import render_file
from pbrt_tpu_torch.tools import pbrt_render
from pbrt_tpu_torch.tools.pbrt_render import AOV_CHANNELS

from . import torch_port_cli as tc
from .torch_port_helpers import share_close

torch.set_num_threads(2)
GOLDEN = np.load(tc.GOLDEN)
GOLDEN_FILES = os.path.join(os.path.dirname(__file__), "goldens")


def _cli(*argv):
    """pbrt_render.main on the CPU; returns (rc, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pbrt_render.main([*map(str, argv), "--device", "cpu"])
    return rc, buf.getvalue()


def _rgb(path):
    img, chans, meta = read_exr(path)
    return np.stack([img[..., chans.index(c)] for c in "RGB"], -1), meta


def _gate(got, want):
    share, n_off = share_close(got, want, rtol=1e-3, atol=1e-5)
    assert share >= 0.99, (share, n_off)
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean()), (
        got.mean(), want.mean())


@pytest.fixture(scope="module")
def image_case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_image")
    scene = tc.write_scene(str(tmp), "s.pbrt", tc.IMAGE_SCENE)
    out = str(tmp / "out.exr")
    rc, _ = _cli(scene, "--outfile", out, *tc.IMAGE_ARGS)
    assert rc == 0
    return scene, out


@pytest.fixture(scope="module")
def gbuffer_case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_gbuffer")
    scene = tc.write_scene(str(tmp), "s.pbrt", tc.GBUFFER_SCENE)
    rc, _ = _cli(scene, "--outfile", str(tmp / "o.exr"), *tc.GBUFFER_ARGS)
    assert rc == 0
    aov, chans, _ = read_exr(str(tmp / "o_aov.exr"))
    spectral, schans, _ = read_exr(str(tmp / "o_spectral.exr"))
    return aov, chans, spectral, schans


def test_cli_image_matches_golden(image_case):
    img, meta = _rgb(image_case[1])
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    _gate(img, GOLDEN["image"])


def test_cli_image_equals_render_file(image_case):
    scene_path, out = image_case
    img, meta = _rgb(out)
    # The reference's EXR metadata keys; spp 4 rounded to passes of 2.
    assert set(meta) >= {"samplesPerPixel", "renderTimeSeconds", "generator"}
    assert meta["samplesPerPixel"] == "4"
    scene, camera, settings = load_pbrt(scene_path, device="cpu")
    want = render_file(scene, camera, settings, spp=4, seed=0,
                       samples_per_pass=2, device="cpu").numpy()
    assert np.array_equal(img, want)


@pytest.fixture(scope="module")
def gbuffer_valid(tmp_path_factory):
    """The share of each pixel's samples that hit a surface, from
    render_aovs at the CLI's arguments (the EXR has no such channel)."""
    tmp = tmp_path_factory.mktemp("cli_valid")
    scene_path = tc.write_scene(str(tmp), "s.pbrt", tc.GBUFFER_SCENE)
    scene, camera, settings = load_pbrt(scene_path, device="cpu")
    return render_aovs(scene, camera, settings["integrator"], spp=4, seed=0,
                       device="cpu")["valid"].numpy()


@pytest.mark.parametrize("channel", AOV_CHANNELS)
def test_cli_gbuffer_channel_matches_golden(gbuffer_case, gbuffer_valid,
                                            channel):
    aov, chans, _, _ = gbuffer_case
    assert sorted(chans) == sorted(GOLDEN["aov_channels"].tolist())
    got = aov[..., chans.index(channel)]
    want = GOLDEN["aov"][..., list(GOLDEN["aov_channels"]).index(channel)]
    if channel in ("MaterialId", "PrimId"):
        assert np.array_equal(got, want)
        return
    if channel in ("Nx", "Ny", "Nz"):
        # Pixels whose every sample hits a surface, and pixels no sample
        # hits: there the port writes 0, the reference triangle 0's facing
        # normal (its y is +-1 here, the others 0).
        valid = gbuffer_valid
        assert np.all(got[valid == 0.0] == 0.0) and np.sum(valid == 1.0) >= 16
        got, want = got[valid == 1.0], want[valid == 1.0]
    _gate(got, want)


def test_cli_spectral_buckets_match_golden(gbuffer_case):
    _, _, spectral, schans = gbuffer_case
    assert schans == [f"L{i:02d}" for i in range(6)]
    _gate(spectral, GOLDEN["spectral"])


def test_cli_debugstart_matches_golden_and_replays(tmp_path):
    scene = tc.write_scene(str(tmp_path), "d.pbrt", tc.DEBUG_SCENE)
    rc, out = _cli(scene, *tc.DEBUG_ARGS)
    assert rc == 0
    rec = json.loads(out.strip().splitlines()[-1])
    assert list(rec) == list(tc.DEBUG_KEYS)
    for key in tc.DEBUG_KEYS:
        np.testing.assert_allclose(np.asarray(rec[key], np.float64),
                                   GOLDEN["debug_" + key], rtol=1e-4,
                                   atol=0, err_msg=key)
    rc, out2 = _cli(scene, *tc.DEBUG_ARGS)
    assert rc == 0 and json.loads(out2.strip().splitlines()[-1]) == rec


def _small_box(tmp_path, res=8, spp=4):
    """box.pbrt at res^2 (its Film line rewritten), K1's scene."""
    with open(os.path.join(GOLDEN_FILES, "box.pbrt")) as f:
        text = f.read()
    text = text.replace("[64]", f"[{res}]").replace(
        '"integer pixelsamples" 4096', f'"integer pixelsamples" {spp}')
    return tc.write_scene(str(tmp_path), "box.pbrt", text)


def test_cli_flags_maxdepth_jitter_png_stats(tmp_path):
    scene_path = _small_box(tmp_path)
    out = str(tmp_path / "o.exr")
    rc, stdout = _cli(scene_path, "--outfile", out, "--spp", "5",
                      "--samples-per-pass", "2", "--maxdepth", "2",
                      "--disable-pixel-jitter", "--stats", "--quiet")
    assert rc == 0
    img, meta = _rgb(out)
    assert meta["samplesPerPixel"] == "4"  # 5 rounded down to passes of 2
    scene, camera, settings = load_pbrt(scene_path, device="cpu")
    settings = {**settings,
                "integrator": settings["integrator"].replace(max_depth=2)}
    want = render_file(scene, camera, settings, spp=4, samples_per_pass=2,
                       jitter=False, device="cpu").numpy()
    assert np.array_equal(img, want)
    stats = json.loads(stdout.strip().splitlines()[-1])
    assert stats["spp"] == 4 and stats["mean"] == pytest.approx(
        float(want.mean()), rel=1e-6)
    # A PNG outfile goes through imgtool's writer (sRGB, 8 bits).
    png = str(tmp_path / "o.png")
    assert _cli(scene_path, "--outfile", png, "--spp", "2",
                "--samples-per-pass", "2", "--quiet")[0] == 0
    assert read_png(png).shape == (8, 8, 3)


def test_cli_mse_harness_and_tev(tmp_path):
    scene_path = _small_box(tmp_path)
    ref = str(tmp_path / "ref.exr")
    write_exr(ref, np.full((8, 8, 3), 0.25, np.float32))
    # A tev server that only records what it is sent.
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = bytearray()

    def serve():
        conn, _ = srv.accept()
        with conn:
            while chunk := conn.recv(65536):
                got.extend(chunk)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    out = str(tmp_path / "o.exr")
    mse_out = str(tmp_path / "mse.jsonl")
    rc, stdout = _cli(scene_path, "--outfile", out, "--spp", "2",
                      "--samples-per-pass", "2", "--quiet",
                      "--mse-reference-image", ref, "--mse-out", mse_out,
                      "--display-server",
                      f"127.0.0.1:{srv.getsockname()[1]}")
    th.join(10)
    srv.close()
    assert rc == 0 and not th.is_alive()
    img, _ = _rgb(out)
    rec = json.loads(stdout.strip().splitlines()[-1])
    assert rec["spp"] == 2
    assert rec["mse"] == pytest.approx(float(np.mean((img - 0.25) ** 2)),
                                       rel=1e-6)
    with open(mse_out) as f:
        assert json.loads(f.read().strip()) == rec
    # CreateImage then one UpdateImage per channel, each carrying the
    # whole 8x8 channel.
    assert got[4] == 4 and len(got) > 3 * 8 * 8 * 4


def test_cli_function_integrator(tmp_path):
    scene_path = tc.write_scene(str(tmp_path), "f.pbrt", (
        'Film "rgb" "integer xresolution" [4] "integer yresolution" [4]\n'
        'Integrator "function" "string function" "step"\n'
        'Camera "perspective"\nWorldBegin\n'))
    out = str(tmp_path / "f.exr")
    rc, stdout = _cli(scene_path, "--outfile", out, "--spp", "4",
                      "--samples-per-pass", "4", "--quiet")
    assert rc == 0
    assert stdout.startswith("function=step exact=")
    img, _ = _rgb(out)
    assert img.shape == (4, 4, 3) and np.array_equal(img[..., 0], img[..., 2])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_interactive_viewer_exits_on_escape(tmp_path):
    scene_path = _small_box(tmp_path)
    out = str(tmp_path / "live.exr")
    port = _free_port()
    err = []

    def run():
        try:
            _cli(scene_path, "--outfile", out, "--interactive",
                 "--gui-port", str(port), "--samples-per-pass", "1",
                 "--quiet")
        except Exception as e:  # reported by the assertion below
            err.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{port}/"
    deadline = time.time() + 60
    while True:
        try:
            state = json.loads(urllib.request.urlopen(url + "state",
                                                      timeout=5).read())
            if state["frame"] > 0:
                break
        except OSError:
            pass
        assert time.time() < deadline and not err, err
        time.sleep(0.05)
    urllib.request.urlopen(urllib.request.Request(
        url + "key", data=b"Escape", method="POST"), timeout=5).read()
    th.join(60)
    assert not th.is_alive() and not err, err
    img, _ = _rgb(out)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


_FORMAT_SCENE = """
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [32] "integer yresolution" [32]
  "float scale" [2]
Sampler "lowdiscrepancy" "integer pixelsamples" [8]
Integrator "directlighting"
WorldBegin
LightSource "point" "point3 from" [0 5 0] "rgb I" [10 10 10]
AttributeBegin
  Translate 0 0 3
  Rotate 45 0 1 0
  Material "matte" "rgb Kd" [0.6 0.5 0.4]
  Shape "trianglemesh"
    "point3 P" [ -1 -1 0  1 -1 0  1 1 0  -1 1 0 ]
    "integer indices" [ 0 1 2  0 2 3 ]
AttributeEnd
Material "glass" "float index" [1.7]
Shape "sphere" "float radius" [0.5]
"""


@pytest.mark.parametrize("flag", ["--format", "--toply", "--upgrade"])
def test_cli_format_flags_match_reference(tmp_path, flag):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (600, 3))
    big = ('Shape "trianglemesh" "point3 P" ['
           + " ".join(f"{v:.5f}" for v in pts.reshape(-1))
           + '] "integer indices" ['
           + " ".join(str(i) for i in range(600)) + "]\n")
    outs = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        path = tc.write_scene(str(d), "s.pbrt", _FORMAT_SCENE + big)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if name == "jax":
                jax_format.format_file(path, to_ply=flag == "--toply",
                                       upgrade=flag == "--upgrade")
            else:
                assert pbrt_render.main([path, flag]) is None
        outs[name] = (buf.getvalue(), sorted(os.listdir(d)))
        if flag == "--toply":
            with open(d / "mesh_00001.ply", "rb") as f:
                outs[name] += (f.read(),)
    assert outs["port"] == outs["jax"]
    assert ('Shape "plymesh"' in outs["port"][0]) == (flag == "--toply")


def test_cli_cuda_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene_path = _small_box(tmp_path)
    out = tmp_path / "o.exr"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbrt_render.main([scene_path, "--outfile", str(out), "--quiet"])
    assert not out.exists()
