"""The port's utilities (pbrt_tpu_torch/utils/: stats, display, denoise,
flip, sky, profile, gui) and item 17's colorspace and transform helpers
against the JAX package's on the same inputs, on the CPU.

The numpy copies (stats' PixelStats, the tev client's bytes, the
denoiser, FLIP, the Preetham and Hosek-Wilkie skies) are bit-equal to
the reference's; the Hosek sky also within tests/test_sky.py's 5e-3 of
the reference model's own samples (tests/goldens/hosek_samples.txt).
The colour-space matrices and white balance are bit-equal; srgb_encode
within one float32 ulp (torch's and XLA's power round differently);
the transforms bit-equal where numpy builds them, within 1e-6 where
torch and XLA multiply. The viewer's HTTP surface and keyboard protocol
match the reference's key for key, and interactive_render_loop's two
passes are within 1e-6 of render() at the same spp. profile.capture of
a CPU render writes a Chrome trace holding the scope's name.
"""

import json
import os
import socket
import threading
import urllib.request

import numpy as np
import pytest
import torch

from pbrt_tpu.core import colorspace as jax_cs
from pbrt_tpu.core import transform as jax_tf
from pbrt_tpu.utils import denoise as jax_denoise
from pbrt_tpu.utils import display as jax_display
from pbrt_tpu.utils import flip as jax_flip
from pbrt_tpu.utils import gui as jax_gui
from pbrt_tpu.utils import sky as jax_sky
from pbrt_tpu.utils import stats as jax_stats
from pbrt_tpu_torch.core import colorspace as cs
from pbrt_tpu_torch.core import transform as tf
from pbrt_tpu_torch.io.image import read_exr
from pbrt_tpu_torch.models.path import PathIntegrator
from pbrt_tpu_torch.render import render
from pbrt_tpu_torch.scenes.cornell import cornell_box
from pbrt_tpu_torch.utils import denoise, display, flip, gui, profile, sky
from pbrt_tpu_torch.utils import stats

torch.set_num_threads(2)
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


# --- stats -------------------------------------------------------------------

def test_stats_report_and_progress(capfd):
    stats.STATS.clear()
    stats.STATS.add("rays traced", 100)
    stats.STATS.add("rays traced", 50)
    stats.STATS.observe("bounce depth", 3)
    stats.STATS.report()
    err = capfd.readouterr().err
    assert "rays traced" in err and "150" in err and "bounce depth" in err
    pr = stats.ProgressReporter(10, quiet=True)
    for _ in range(10):
        pr.update()
    assert pr.done == 10
    pr = stats.ProgressReporter(4, title="Pass")
    pr.update(2)
    pr.finish()
    assert pr.done == 4 and "Pass: [" in capfd.readouterr().err
    stats.STATS.clear()


def test_check_rare_on_tensors_matches_reference(capsys):
    masks = [np.zeros(5000, bool), np.ones(100, bool),
             np.random.default_rng(0).random(3000) < 0.01]
    stats._RARE.clear()
    jax_stats._RARE.clear()
    for m in masks:
        got = stats.check_rare("unit_rare", torch.from_numpy(m))
        assert got == jax_stats.check_rare("unit_rare", m)
    assert stats.rare_report() == jax_stats.rare_report()
    rep = stats.rare_report()["unit_rare"]
    assert rep["total"] == 8100
    assert "unit_rare" in capsys.readouterr().err  # above the 1e-3 default
    stats._RARE.clear()
    jax_stats._RARE.clear()


def test_pixel_stats_exr_matches_reference(tmp_path):
    files = {}
    for name, mod in (("jax", jax_stats), ("port", stats)):
        ps = mod.PixelStats(4, 3)
        ids = [0, 0, 5, 11]
        ps.add("shadow_rays", torch.tensor(ids) if mod is stats else ids)
        ps.add("bounces", [2, 2, 2], [1.5, 1.5, 2.0])
        path = str(tmp_path / f"{name}.exr")
        assert ps.write(path) == ["bounces", "shadow_rays"]
        with open(path, "rb") as f:
            files[name] = f.read()
    assert files["port"] == files["jax"]
    img, chans, _ = read_exr(str(tmp_path / "port.exr"))
    sr = img[..., chans.index("shadow_rays")].reshape(-1)
    assert sr[0] == 2.0 and sr[5] == 1.0 and sr[11] == 1.0


def test_buffercache_report_feeds_stats():
    from pbrt_tpu_torch.io.buffercache import BufferCache

    stats.STATS.clear()
    cache = BufferCache()
    a = np.arange(12, dtype=np.float32)
    cache.canonical(a)
    cache.canonical(a.copy())
    counters = cache.report_stats()
    assert counters == {"buffercache/lookups": 2, "buffercache/hits": 1,
                        "buffercache/redundant MB": 0}
    for name, value in counters.items():
        assert stats.STATS.counters[name] == value
    stats.STATS.clear()


# --- the tev client ----------------------------------------------------------

def _tev_bytes(send, img):
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
    ok = send(img, name="x", port=srv.getsockname()[1])
    th.join(10)
    srv.close()
    assert ok and not th.is_alive()
    return bytes(got)


def test_tev_client_bytes_match_reference():
    img = np.random.default_rng(1).random((5, 7, 3)).astype(np.float32)
    assert (_tev_bytes(display.send_to_tev, img)
            == _tev_bytes(jax_display.send_to_tev, img))
    # No server: a graceful False, no exception.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert display.send_to_tev(img, port=port) is False


# --- denoise, FLIP -----------------------------------------------------------

def _noisy_edge(seed=0):
    rng = np.random.default_rng(seed)
    img = np.zeros((48, 48, 3), np.float32)
    img[:, :24] = 0.2
    img[:, 24:] = 1.0
    noisy = img + rng.normal(0, 0.25, img.shape).astype(np.float32)
    normal = np.zeros_like(img)
    normal[..., 2] = 1.0
    depth = np.full((48, 48), 3.0, np.float32)
    return img, np.clip(noisy, 0, None), img.copy(), normal, depth


@pytest.mark.parametrize("guides", [True, False], ids=["guided", "plain"])
def test_denoise_matches_reference(guides):
    clean, noisy, albedo, normal, depth = _noisy_edge(int(guides))
    kw = dict(albedo=albedo, normal=normal, depth=depth) if guides else {}
    out = denoise.denoise(noisy, **kw)
    assert np.array_equal(out, jax_denoise.denoise(noisy, **kw))
    mse_in = float(((noisy - clean) ** 2).mean())
    mse_out = float(((out - clean) ** 2).mean())
    assert mse_out < (0.25 if guides else 0.6) * mse_in
    if guides:
        prof = out[:, :, 0].mean(0)
        assert prof[21] < 0.45 and prof[27] > 0.75


def test_flip_matches_reference():
    rng = np.random.default_rng(5)
    img = rng.random((48, 48, 3)).astype(np.float32) * 0.5
    for off in (0.0, 0.02, 0.2):
        test = np.clip(img + off, 0, 1)
        m = flip.flip_error_map(img, test, ppd=40.0)
        assert np.array_equal(m, jax_flip.flip_error_map(img, test, ppd=40.0))
    assert flip.mean_flip(img, img) < 1e-6
    assert 0.0 < flip.mean_flip(img, np.clip(img + 0.02, 0, 1)) < \
        flip.mean_flip(img, np.clip(img + 0.2, 0, 1)) <= 1.0


# --- skies -------------------------------------------------------------------

def test_hosek_sky_matches_reference():
    cfg, rad = sky.hosek_configs(3.5, 0.3, 0.4)
    jcfg, jrad = jax_sky.hosek_configs(3.5, 0.3, 0.4)
    assert np.array_equal(cfg, jcfg) and np.array_equal(rad, jrad)
    img = sky.make_sky_latlong_hosek(24, sun_elevation_deg=25, turbidity=3)
    assert np.array_equal(img, jax_sky.make_sky_latlong_hosek(
        24, sun_elevation_deg=25, turbidity=3))
    assert img.shape == (24, 48, 3) and (img >= 0).all()
    assert img[:10].mean() > 0.01 and img[-4:].max() == 0.0
    pre = sky.make_sky_latlong(16, sun_elevation_deg=40, sun_half_angle=4.0)
    assert np.array_equal(pre, jax_sky.make_sky_latlong(
        16, sun_elevation_deg=40, sun_half_angle=4.0))


def _hosek_samples():
    rows = {"sky": [], "sun": []}
    with open(os.path.join(GOLDENS, "hosek_samples.txt")) as f:
        for line in f:
            parts = line.split()
            rows[parts[0]].append([float(x) for x in parts[1:]])
    return {k: np.asarray(v) for k, v in rows.items()}


@pytest.mark.parametrize("kind", ["sky", "sun"])
def test_hosek_matches_reference_model_samples(kind):
    """tests/test_sky.py's gates: within 5e-3 of the reference model's own
    samples (the sun's radiance is direct plus the sky's)."""
    rows = _hosek_samples()[kind]
    worst = 0.0
    for row in rows:
        turb, alb, elev, theta, gamma, lam, ref = row
        cfg, rad = sky.hosek_configs(turb, alb, elev)
        val = float(sky.hosek_radiance(np.asarray(theta), np.asarray(gamma),
                                       np.asarray([lam]), cfg, rad)[0])
        if kind == "sun":
            val += float(sky.hosek_solar_radiance(
                np.asarray(np.pi / 2 - theta), np.asarray(gamma),
                np.asarray([lam]), turb)[0])
        worst = max(worst, abs(val - ref) / max(abs(ref), 1e-6))
    assert worst < 5e-3, worst


# --- colorspace and transform helpers (item 17) -----------------------------

def test_colorspaces_match_reference():
    assert sorted(cs.COLOR_SPACES) == sorted(jax_cs.COLOR_SPACES)
    for name, space in cs.COLOR_SPACES.items():
        ref = jax_cs.COLOR_SPACES[name]
        assert np.array_equal(space.rgb_from_xyz, ref.rgb_from_xyz)
        assert np.array_equal(space.xyz_from_rgb, ref.xyz_from_rgb)
        assert space.white_xy == ref.white_xy
    rgb = np.random.default_rng(0).random((64, 3)).astype(np.float32)
    got = cs.REC2020.to_xyz(torch.from_numpy(rgb)).numpy()
    want = np.asarray(jax_cs.REC2020.to_xyz(rgb))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.array_equal(cs.white_balance_matrix((0.35, 0.36), (0.31, 0.33)),
                          jax_cs.white_balance_matrix((0.35, 0.36),
                                                      (0.31, 0.33)))


def test_srgb_transfer_matches_reference():
    x = np.random.default_rng(1).uniform(-0.1, 1.2, 100_000).astype(np.float32)
    want = np.asarray(jax_cs.srgb_encode(x))
    got = cs.srgb_encode(x)  # a host array in, a host array out
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    # One float32 ulp at most (the power's last bit).
    assert np.abs(got - want).max() <= 1.2e-7
    assert np.array_equal(cs.srgb_encode(torch.from_numpy(x)).numpy(), got)
    y = np.clip(x, 0, 1)
    np.testing.assert_allclose(cs.srgb_decode(y),
                               np.asarray(jax_cs.srgb_decode(y)),
                               rtol=3e-7, atol=1e-9)
    np.testing.assert_allclose(cs.srgb_decode(cs.srgb_encode(y)), y,
                               rtol=1e-5, atol=1e-6)


def _m(t):
    return (t.m.numpy() if isinstance(t.m, torch.Tensor) else
            np.asarray(t.m))


def test_transform_helpers_match_reference():
    for fn in ("rotate_x", "rotate_y", "rotate_z"):
        assert np.array_equal(_m(getattr(tf, fn)(33.0)),
                              _m(getattr(jax_tf, fn)(33.0)))
    np.testing.assert_allclose(_m(tf.perspective(40.0)),
                               _m(jax_tf.perspective(40.0)), rtol=1e-6)
    assert np.array_equal(_m(tf.Transform.identity()), np.eye(4))
    a = tf.translate(np.array([0.1, -2.0, 3.0])) @ tf.rotate_y(20.0)
    b = tf.scale([1.0, -2.0, 0.5]) @ tf.rotate_x(-70.0)
    ja = jax_tf.translate(np.array([0.1, -2.0, 3.0])) @ jax_tf.rotate_y(20.0)
    jb = jax_tf.scale([1.0, -2.0, 0.5]) @ jax_tf.rotate_x(-70.0)
    ab, jab = a @ b, ja @ jb
    np.testing.assert_allclose(_m(ab), _m(jab), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ab.m_inv.numpy(), np.asarray(jab.m_inv),
                               rtol=1e-6, atol=1e-6)
    v = np.random.default_rng(2).normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(ab.apply_normal(torch.from_numpy(v)).numpy(),
                               np.asarray(jab.apply_normal(v)), rtol=1e-5,
                               atol=1e-6)
    o, d = ab.apply_ray(torch.from_numpy(v), torch.from_numpy(v[::-1].copy()))
    jo, jd = jab.apply_ray(v, v[::-1].copy())
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    assert bool(b.swaps_handedness()) == bool(jb.swaps_handedness()) is True
    assert bool(a.swaps_handedness()) is False


# --- profile -----------------------------------------------------------------

def test_profile_capture_of_a_cpu_render(tmp_path):
    scene, camera = cornell_box(resolution=(2, 2))
    scene = scene.with_accel()
    integ = PathIntegrator(max_depth=1)

    @profile.scope("test/outer")
    def go():
        with profile.scope("cli/render"):
            return render(scene, camera, integ, spp=1, n_spectrum=4,
                          device="cpu")

    with profile.capture(str(tmp_path)):
        img = go()
    with open(tmp_path / profile.TRACE_FILE) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"cli/render", "test/outer"} <= names
    assert profile.sync(img) == pytest.approx(float(img.sum()))
    times = profile.timed_breakdown({"a": lambda: torch.ones(3)}, 1, 2)
    assert set(times) == {"a"} and times["a"] > 0.0


# --- the viewer --------------------------------------------------------------

def _post(url, data=b""):
    req = urllib.request.Request(url, data=data, method="POST")
    return urllib.request.urlopen(req, timeout=5).read()


def _get(url):
    return urllib.request.urlopen(url, timeout=5).read()


def test_gui_http_surface():
    g = gui.GUI("test", (8, 8))
    try:
        page = _get(g.url).decode()
        assert "frame.png" in page and "test" in page
        st = json.loads(_get(g.url + "state"))
        assert st == {"frame": 0, "spp": 0, "exposure": 1.0}
        g.update_framebuffer(np.full((8, 8, 3), 0.5, np.float32), spp=4)
        assert _get(g.url + "frame.png")[:8] == b"\x89PNG\r\n\x1a\n"
        assert json.loads(_get(g.url + "state"))["frame"] == 1
    finally:
        g.close()


def test_gui_keyboard_protocol_matches_reference():
    keys = [[], ["w"], ["ArrowRight", "a"], ["="], ["c"], ["q", "ArrowUp",
            "-", "d", "s", "e", "ArrowLeft", "ArrowDown"], ["Escape"], []]
    guis = {"jax": jax_gui.GUI("t", (8, 8)), "port": gui.GUI("t", (8, 8))}
    try:
        for batch in keys:
            states = {}
            for name, g in guis.items():
                for k in batch:
                    _post(g.url + "key", k.encode())
                states[name] = (g.refresh_display().name, g.exposure,
                                g.print_camera_transform)
            assert states["port"] == states["jax"], batch
            np.testing.assert_allclose(
                _m(guis["port"].get_camera_transform()),
                _m(guis["jax"].get_camera_transform()), rtol=1e-6, atol=1e-7)
    finally:
        for g in guis.values():
            g.close()


def test_interactive_render_loop_matches_render():
    scene, camera = cornell_box(resolution=(8, 8))
    scene = scene.with_accel()
    integ = PathIntegrator(max_depth=2)
    g = gui.GUI("loop", camera.resolution)
    try:
        img = gui.interactive_render_loop(scene, camera, integ, g,
                                          samples_per_pass=1, max_passes=2,
                                          device="cpu")
        want = render(scene, camera, integ, spp=2, samples_per_pass=1,
                      device="cpu").numpy()
        assert img.shape == (8, 8, 3) and img.max() > 0.0
        np.testing.assert_allclose(img, want, rtol=1e-6, atol=1e-6)
        assert json.loads(_get(g.url + "state"))["spp"] == 2
        # A camera move mid-loop resets accumulation (spp restarts).
        _post(g.url + "key", b"w")
        gui.interactive_render_loop(scene, camera, integ, g,
                                    samples_per_pass=1, max_passes=3,
                                    device="cpu")
        assert json.loads(_get(g.url + "state"))["spp"] < 3
    finally:
        g.close()
