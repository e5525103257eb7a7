"""The port's utils/native (csrc/wrt_host.cpp through ctypes, with a
NumPy/PyTorch route when the library is missing) against the JAX
package's module, byte for byte on both routes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from weekend_raytracer_tpu.utils import native as jnative  # noqa: E402
from weekend_raytracer_tpu_torch.interactive.viewer import _halfblock_frame  # noqa: E402
from weekend_raytracer_tpu_torch.utils import native as tnative  # noqa: E402


@pytest.fixture(params=["library", "numpy"])
def route(request, monkeypatch):
    """Both modules on the route named: the host library, or (the library
    withheld) their NumPy route."""
    if request.param == "library":
        assert jnative.available() and tnative.available()
    else:
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "_load", lambda: None)
            assert not mod.available()
    return request.param


def test_both_load_the_one_host_library():
    assert tnative.available() and jnative.available()
    assert tnative._LIB_PATH == jnative._LIB_PATH


def test_tonemap_is_the_jax_modules_bytes(route):
    """tests/test_native.py's input, byte for byte on both routes. On a wider
    input the NumPy routes (torch.pow against XLA's pow) may round a value
    one step apart, as tests/test_torch_models.py's test_tonemap_matches
    holds the two tonemaps: at most 1, on under 1e-3 of the values."""
    rs = np.random.RandomState(0)
    x = (rs.rand(64, 32, 3) * 20.0).astype(np.float32)
    got, want = tnative.tonemap_u8(x), jnative.tonemap_u8(x)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    wide = (rs.rand(256, 256, 3) * rs.choice([0.1, 1.0, 20.0], (256, 256, 1))).astype(np.float32)
    got, want = (m.tonemap_u8(wide).astype(np.int32) for m in (tnative, jnative))
    if route == "library":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1 and (got != want).mean() < 1e-3


@pytest.mark.parametrize("shape", [(8, 6, 3), (9, 7, 3), (2, 1, 3)])
def test_halfblock_render_is_the_jax_modules_string(route, shape):
    img = (np.random.RandomState(2).rand(*shape) * 255).astype(np.uint8)
    got = tnative.halfblock_render(img)
    assert got == jnative.halfblock_render(img)
    # the library ends the frame with a newline, the NumPy route does not
    assert got == _halfblock_frame(img) + ("\n" if route == "library" else "")


@pytest.mark.parametrize("seed,n,scale", [(1, 500, 100.0), (4, 3000, 4.0), (5, 7, 1.0)])
def test_morton_argsort_is_the_jax_modules_order(route, seed, n, scale):
    """Scattered centers, and a coarse grid where many codes tie."""
    rs = np.random.RandomState(seed)
    c = (rs.rand(n, 3) * scale - scale / 2).astype(np.float32)
    if scale == 4.0:
        c = np.round(c)
    got = tnative.morton_argsort(c)
    assert got.dtype == np.int32 and sorted(got.tolist()) == list(range(n))
    np.testing.assert_array_equal(got, jnative.morton_argsort(c))


def test_write_ppm_is_the_jax_modules_file(route, tmp_path):
    img = (np.random.RandomState(3).rand(10, 7, 3) * 255).astype(np.uint8)
    tnative.write_ppm(str(tmp_path / "t.ppm"), img)
    jnative.write_ppm(str(tmp_path / "j.ppm"), img)
    data = (tmp_path / "t.ppm").read_bytes()
    assert data == (tmp_path / "j.ppm").read_bytes()
    assert data.startswith(b"P6\n7 10\n255\n")
    np.testing.assert_array_equal(
        np.frombuffer(data.split(b"255\n", 1)[1], dtype=np.uint8).reshape(10, 7, 3), img)
