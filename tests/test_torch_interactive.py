"""The port's fly camera and terminal viewer (interactive/) against the JAX
package's, on the CPU: the controller's numpy math in every bit, the
viewer's key map and mouse, its half-block frame and its raw-input
parsing."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from weekend_raytracer_tpu.interactive import fly_camera as jfly  # noqa: E402
from weekend_raytracer_tpu.interactive import viewer as jviewer  # noqa: E402
from weekend_raytracer_tpu.models import scenes as jscenes  # noqa: E402
from weekend_raytracer_tpu.models.angle import Angle as JAngle  # noqa: E402
from weekend_raytracer_tpu.ops.tonemap import to_srgb_u8  # noqa: E402
import weekend_raytracer_tpu_torch as twrt  # noqa: E402
from weekend_raytracer_tpu_torch.interactive import fly_camera as tfly  # noqa: E402
from weekend_raytracer_tpu_torch.interactive import viewer as tviewer  # noqa: E402
from weekend_raytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from weekend_raytracer_tpu_torch.models.angle import Angle as TAngle  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _camera(cam):
    return (cam.eye_pos, cam.eye_dir, cam.up, cam.vfov.as_radians(), cam.aperture,
            cam.focus_distance)


def _state(c):
    return (c.position.tolist(), c.yaw.as_radians(), c.pitch.as_radians(), c.vfov_degrees,
            c.aperture, c.focus_distance, c.previous_mouse_pos, c.mouse_pos,
            c.look_pressed, _camera(c.renderer_camera()))


# a scripted path: (kind, args); "key" presses, moves and releases, "mouse"
# is a cursor event, "frame" applies look and translation
_PATH = ([("key", "w", 2.0), ("key", "q", 1.0), ("key", "a", 0.5), ("key", "d", 3.0),
          ("key", "s", 1.5), ("key", "e", 0.25), ("key", "x", 1.0),
          ("mouse", (50.0, 50.0), True), ("frame", 0.0), ("mouse", (60.0, 50.0), True),
          ("frame", 0.0), ("mouse", (63.0, 41.0), True), ("frame", 0.5),
          ("mouse", (63.0, 41.0), False), ("frame", 0.0), ("mouse", (10.0, 90.0), True),
          ("frame", 0.0), ("mouse", (12.0, 80.0), True), ("frame", 1.0)]
         # vertical drags of 40 pixels, released and pressed again, until
         # the pitch clamps at +89 degrees, then at -89
         + [step for sign in (1.0, -1.0) for _ in range(30) for step in
            [("mouse", (50.0, 50.0), False), ("frame", 0.0),
             ("mouse", (50.0, 50.0), True), ("frame", 0.0)]
            + [s for k in range(1, 6) for s in (("mouse", (50.0, 50.0 + sign * 8.0 * k), True),
                                                ("frame", 0.0))]]
         + [("key", "w", 1.0), ("mouse", (50.0, 50.0), False), ("frame", 0.0)])


def test_fly_camera_follows_the_jax_controller_in_every_bit():
    j, t = jfly.FlyCameraController(), tfly.FlyCameraController()
    assert _state(t) == _state(j)
    clamped = set()
    for kind, *args in _PATH:
        for c in (j, t):
            if kind == "key":
                c.set_key(args[0], True)
                c.after_events((100, 100), args[1])
                c.set_key(args[0], False)
            elif kind == "mouse":
                c.set_mouse(*args)
            else:
                c.after_events((100, 100), args[0])
        assert _state(t) == _state(j), (kind, args)
        clamped |= {p for p in (89.0, -89.0) if abs(t.pitch.as_degrees() - p) < 1e-9}
    assert clamped == {89.0, -89.0}, "the path did not reach both pitch clamps"
    for yaw, pitch in ((30.0, 90.0), (30.0, -90.0), (-120.0, 45.0), (0.0, 0.0)):
        jo = jfly.camera_orientation(JAngle.degrees(yaw), JAngle.degrees(pitch))
        to = tfly.camera_orientation(TAngle.degrees(yaw), TAngle.degrees(pitch))
        for field in ("forward", "right", "up"):
            np.testing.assert_array_equal(getattr(to, field), getattr(jo, field))


_KEYS = ["F", "f", "f", "g", "G", "G", "v", "V", "V", "t", "T", "T", "z", "Z", "x", "X",
         "X", "2", "1", "4", "b", "B", "B", "w", "a", "s", "d", "q", "e", "i", "i", "j",
         "k", "l", "r", "", "?", "2"]
_MOUSE = [(10, 5, True), (16, 7, True), (16, 7, False), (20, 9, False), (3, 2, True),
          (30, 17, True), (0, 0, True), (0, 0, False)]


def test_viewer_key_map_and_mouse_follow_the_jax_viewer():
    """32x18 with backend="xla": after every key and mouse event both viewers
    hold the same camera, sky, sampling and status, and the same sample
    count (an edit resets accumulation; "r" resets it too). A frame rendered
    before and after the script agrees at test_torch_xla.py's tolerance."""
    j = jviewer.TerminalViewer(jscenes.three_spheres(), jfly.FlyCameraController(),
                               viewport=(32, 18), backend="xla")
    t = tviewer.TerminalViewer(tscenes.three_spheres(), tfly.FlyCameraController(),
                               viewport=(32, 18), backend="xla", device="cpu")
    assert t.renderer.device == torch.device("cpu")

    def same():
        assert _camera(t.params.camera) == _camera(j.params.camera)
        for a, b in ((t.params.sky, j.params.sky), (t.sky, j.sky),
                     (t.params.sampling, j.params.sampling), (t.sampling, j.sampling)):
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert t.status == j.status
        assert t.renderer.accumulated_samples() == j.renderer.accumulated_samples()
        assert _state(t.controller) == _state(j.controller)

    for v in (j, t):
        assert v.renderer.render_frame()
    same()
    for key in _KEYS:
        assert t.handle_key(key) == j.handle_key(key), key
        same()
        if key == "G":  # a frame between edits: the next edit resets it
            assert t.renderer.render_frame() == j.renderer.render_frame()
            same()
    for col, row, pressed in _MOUSE:
        j.handle_mouse(col, row, pressed)
        t.handle_mouse(col, row, pressed)
        same()
    for key in ("\x1b", "\x03"):
        assert not t.handle_key(key) and not j.handle_key(key)
    for v in (j, t):
        assert v.renderer.render_frame()
    same()
    got = t.renderer.mean_radiance().numpy()
    want = np.asarray(j.renderer.mean_radiance())
    close = np.isclose(got, want, rtol=1e-2, atol=1e-3).all(axis=-1)
    assert close.mean() > 0.98
    assert np.sqrt(((got[close] - want[close]) ** 2).mean()) < 1e-4
    tm = [np.asarray(to_srgb_u8(jnp.asarray(a))).astype(np.float32) / 255 for a in (got, want)]
    assert np.sqrt(((tm[0] - tm[1]) ** 2).mean()) < 5e-3
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-3


@pytest.mark.parametrize("h,w", [(8, 6), (9, 5), (1, 3), (0, 4)])
def test_halfblock_frame_is_the_jax_string(h, w):
    img = (np.random.RandomState(h * 7 + w).rand(h, w, 3) * 255).astype(np.uint8)
    assert tviewer._halfblock_frame(img) == jviewer._halfblock_frame(img)


# escape sequences, SGR mouse reports (press, release, scroll, malformed),
# unknown sequences, a lone ESC and EOF
_STREAM = (b"\x1b[A\x1b[B\x1b[C\x1b[Dw\x1b[<0;11;6M\x1b[<0;17;8m\x1b[<64;1;1M"
           b"\x1b[<1;2M\x1b[Z\x1bqx\x1b[<0;3;4M")


def _replay(mod, data, n_keys):
    """Keys and mouse calls that ``mod``'s viewer reads from ``data``, then
    EOF; the viewer's render state is never touched."""
    r, w = os.pipe()
    try:
        os.write(w, data)
        os.close(w)
        w = -1
        v = mod.TerminalViewer.__new__(mod.TerminalViewer)
        v._in = mod._RawInput(r)
        calls = []
        v.handle_mouse = lambda *a: calls.append(a)
        keys = [v._read_key() for _ in range(n_keys)]
        return keys, calls, v._in.eof
    finally:
        os.close(r)
        if w >= 0:
            os.close(w)


def test_raw_input_parsing_gives_the_jax_keys():
    got = _replay(tviewer, _STREAM, 14)
    assert got == _replay(jviewer, _STREAM, 14)
    keys, calls, eof = got
    assert keys[:5] == ["i", "k", "l", "j", "w"] and keys[-1] == "\x1b" and eof
    assert calls == [(10, 5, True), (16, 7, False), (2, 3, True)]
    assert _replay(tviewer, b"\x1b", 1) == _replay(jviewer, b"\x1b", 1)


def test_raw_input_buffer_and_timeouts_as_jax():
    def trace(mod):
        r, w = os.pipe()
        try:
            os.write(w, b"\x1b[Aq")
            inp = mod._RawInput(r)
            out = [inp.pending(), inp.read1(), inp.read1(timeout=0.01),
                   inp.read1(timeout=0.01), inp.read1(), inp.pending(),
                   inp.read1(timeout=0.01), inp.eof]
            os.close(w)
            w = -1
            return out + [inp.read1(), inp.eof]
        finally:
            os.close(r)
            if w >= 0:
                os.close(w)

    assert trace(tviewer) == trace(jviewer) == [True, "\x1b", "[", "A", "q", False, "",
                                                False, "", True]


def test_renderer_camera_validates():
    c = tfly.FlyCameraController()
    twrt.RenderParams(camera=c.renderer_camera(), viewport_size=(64, 48)).validate()
