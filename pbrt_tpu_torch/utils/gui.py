"""Interactive render viewer (the reference's GUI, as a built-in HTTP
viewer).

Port of pbrt_tpu/utils/gui.py: the server, page and keyboard protocol
are the reference's; the render loop runs the port's render() on the
caller's device.

Reference analogue: `util/gui.h:27` — a GLFW/OpenGL window with keyboard
camera controls, exposure adjustment, and a RESET/EXIT display-state protocol
driven by `wavefront/integrator.cpp:444-472` (map framebuffer, refresh, reset
accumulation when the camera moves).

A renderer on a headless accelerator host has no window, so the
equivalent of a GLFW window is a built-in HTTP viewer: the render loop pushes tonemapped
frames, any browser shows them live and sends back keyboard input. The GUI
class keeps the reference's exact interaction surface — `refresh_display()
-> DisplayState`, `camera_transform`, `exposure`, `print_camera_transform` —
so the render loop code matches `integrator.cpp`'s shape line for line.

Keyboard mapping (reference `gui.cpp processKeys`):
  w/s   dolly forward/back          a/d   truck left/right
  q/e   pedestal down/up            arrows yaw/pitch
  -/=   exposure down/up            c     print camera transform
  Esc   exit
"""

from __future__ import annotations

import enum
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..core.transform import Transform, rotate_x, rotate_y, translate
from ..io.image import encode_png


class DisplayState(enum.Enum):
    EXIT = 0
    RESET = 1
    NONE = 2


_PAGE = """<!doctype html>
<html><head><title>%TITLE%</title><style>
body { background:#111; color:#ccc; font-family:monospace; margin:1em; }
img  { image-rendering:pixelated; border:1px solid #444; }
</style></head><body>
<div>%TITLE% — wasd/qe move, arrows look, -/= exposure, c print cam, Esc exit</div>
<img id="fb" width="%W%" height="%H%">
<div id="st"></div>
<script>
let fid = -1;
async function tick() {
  try {
    const s = await (await fetch('state')).json();
    document.getElementById('st').textContent =
        'spp ' + s.spp + '  exposure ' + s.exposure.toFixed(2);
    if (s.frame !== fid) {
      fid = s.frame;
      document.getElementById('fb').src = 'frame.png?' + fid;
    }
  } catch (e) {}
  setTimeout(tick, 250);
}
tick();
window.addEventListener('keydown', (e) => {
  fetch('key', {method: 'POST', body: e.key});
  e.preventDefault();
});
</script></body></html>
"""


class GUI:
    """Live viewer server + interaction state (util/gui.h:27 analogue)."""

    def __init__(self, title: str, resolution, port: int = 0):
        self.title = title
        self.resolution = tuple(resolution)  # (nx, ny)
        self.exposure = 1.0
        self.print_camera_transform = False
        self.camera_transform = Transform.identity()  # movingFromCamera
        self.move_scale = 1.0
        self._lock = threading.Lock()
        self._png = encode_png(np.zeros((resolution[1], resolution[0], 3)))
        self._frame_id = 0
        self._spp = 0
        self._keys: list[str] = []
        self._exit = False

        gui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with gui._lock:
                        png = gui._png
                    self._send(200, "image/png", png)
                elif self.path.startswith("/state"):
                    with gui._lock:
                        body = json.dumps(
                            {
                                "frame": gui._frame_id,
                                "spp": gui._spp,
                                "exposure": gui.exposure,
                            }
                        ).encode()
                    self._send(200, "application/json", body)
                else:
                    nx, ny = gui.resolution
                    page = (
                        _PAGE.replace("%TITLE%", gui.title)
                        .replace("%W%", str(nx * max(1, 512 // nx)))
                        .replace("%H%", str(ny * max(1, 512 // nx)))
                    )
                    self._send(200, "text/html", page.encode())

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                key = self.rfile.read(n).decode("utf-8", "replace")
                with gui._lock:
                    gui._keys.append(key)
                self._send(200, "text/plain", b"ok")

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    # -- framebuffer ---------------------------------------------------------
    def update_framebuffer(self, rgb_linear: np.ndarray, spp: int) -> None:
        """Tonemap (exposure + sRGB encode) and publish a frame.

        Plays the role of MapFramebuffer/UnmapFramebuffer +
        UpdateFramebufferFromFilm in the reference (integrator.cpp:445-447).
        """
        img = np.asarray(rgb_linear, np.float32) * self.exposure
        img = np.where(
            img <= 0.0031308, 12.92 * img,
            1.055 * np.maximum(img, 1e-8) ** (1 / 2.4) - 0.055,
        )
        png = encode_png(np.clip(img, 0.0, 1.0))
        with self._lock:
            self._png = png
            self._frame_id += 1
            self._spp = spp

    # -- input / display-state protocol ---------------------------------------
    def refresh_display(self) -> DisplayState:
        """Drain pending keyboard input; mutate camera/exposure state.

        Returns RESET when accumulated samples must be discarded (camera
        moved), EXIT on Escape — the DisplayState protocol of gui.h:25.
        """
        with self._lock:
            keys, self._keys = self._keys, []
        if self._exit:
            return DisplayState.EXIT
        moved = False
        s = 0.1 * self.move_scale
        for k in keys:
            if k == "Escape":
                self._exit = True
                return DisplayState.EXIT
            elif k in ("w", "s", "a", "d", "q", "e"):
                delta = {
                    "w": (0, 0, s), "s": (0, 0, -s),
                    "a": (-s, 0, 0), "d": (s, 0, 0),
                    "q": (0, -s, 0), "e": (0, s, 0),
                }[k]
                self.camera_transform = (
                    self.camera_transform @ translate(np.array(delta))
                )
                moved = True
            elif k in ("ArrowLeft", "ArrowRight"):
                ang = 2.0 if k == "ArrowRight" else -2.0
                self.camera_transform = self.camera_transform @ rotate_y(ang)
                moved = True
            elif k in ("ArrowUp", "ArrowDown"):
                ang = -2.0 if k == "ArrowUp" else 2.0
                self.camera_transform = self.camera_transform @ rotate_x(ang)
                moved = True
            elif k == "-":
                self.exposure *= 0.8
                moved = True
            elif k == "=":
                self.exposure *= 1.25
                moved = True
            elif k == "c":
                self.print_camera_transform = True
        return DisplayState.RESET if moved else DisplayState.NONE

    def get_camera_transform(self) -> Transform:
        return self.camera_transform

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def interactive_render_loop(scene, camera, integrator, gui: GUI,
                            samples_per_pass: int = 1, seed: int = 0,
                            max_passes: int | None = None, *, device):
    """Progressive render loop with live viewing + camera interaction.

    The loop shape mirrors WavefrontPathIntegrator::Render's interactive
    branch (wavefront/integrator.cpp:336-472): accumulate passes, publish the
    tonemapped film, poll the GUI, and on RESET rebuild the camera from
    gui.camera_transform and zero the accumulator. Every pass renders on
    `device`. Returns the final linear image (a host array). max_passes
    bounds the loop for tests/offline use.
    """
    from ..render import render

    base_c2w = camera.camera_to_world
    acc = None
    n_acc = 0
    passes = 0
    total_iters = 0
    while max_passes is None or total_iters < max_passes:
        total_iters += 1
        img = render(
            scene, camera, integrator,
            spp=samples_per_pass, seed=seed,
            samples_per_pass=samples_per_pass,
            sample_offset=n_acc, device=device,
        )
        img = img.cpu().numpy()
        acc = img if acc is None else acc + img
        n_acc += samples_per_pass
        passes += 1
        gui.update_framebuffer(acc / max(1, passes), spp=n_acc)
        state = gui.refresh_display()
        if gui.print_camera_transform:
            print("camera_to_world:\n",
                  camera.camera_to_world.m.cpu().numpy())
            gui.print_camera_transform = False
        if state is DisplayState.EXIT:
            break
        if state is DisplayState.RESET:
            move = gui.get_camera_transform().to(base_c2w.m.device)
            camera = camera.replace(camera_to_world=base_c2w @ move)
            acc = None
            n_acc = 0
            passes = 0
    return acc / max(1, passes) if acc is not None else None
