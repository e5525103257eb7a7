"""The port's CLI (weekend_raytracer_tpu_torch/cli.py, ``python -m
weekend_raytracer_tpu_torch``) against the JAX package's, on the CPU."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from weekend_raytracer_tpu import cli as jcli  # noqa: E402
from weekend_raytracer_tpu.ops.tonemap import to_srgb_u8  # noqa: E402
import weekend_raytracer_tpu_torch as twrt  # noqa: E402
from weekend_raytracer_tpu_torch import cli as tcli  # noqa: E402
from weekend_raytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from weekend_raytracer_tpu_torch.models.params import RenderParamsValidationError  # noqa: E402

CLIS = {"jax": jcli, "torch": tcli}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- tests/test_interactive.py:97-118 and :140-149, on both CLIs -----------------

@pytest.mark.parametrize("pkg", list(CLIS))
def test_cli_parse_size(pkg):
    assert CLIS[pkg].parse_size("1920x1080") == (1920, 1080)
    assert CLIS[pkg].parse_size("64X36") == (64, 36)


@pytest.mark.parametrize("pkg", list(CLIS))
def test_cli_unknown_scene_exits_2(pkg, capsys):
    assert CLIS[pkg].main(["--scene", "bogus"]) == 2
    assert "unknown scene" in capsys.readouterr().err


@pytest.mark.parametrize("pkg", list(CLIS))
def test_cli_scene_list(pkg, capsys):
    assert CLIS[pkg].main(["--scene", "list"]) == 0
    out = capsys.readouterr().out
    for name in ("demo", "rtiow", "random10k"):
        assert name in out


@pytest.mark.parametrize("spp,frame_spp", [(50, 2), (100, 4), (7, 1)])
def test_cli_spp_frame_divisor_defaults(spp, frame_spp, tmp_path, capsys):
    """The default samples per frame is the largest of 4, 2, 1 that divides
    --spp (the JAX CLI's rule, which min(4, spp) broke for --spp 50): the
    port's CLI renders every such --spp to the end."""
    assert next(d for d in (4, 2, 1) if spp % d == 0) == frame_spp
    assert tcli.main(["--device", "cpu", "--scene", "single", "--size", "2x2",
                      "--spp", str(spp), "--bounces", "1", "--backend", "xla",
                      "--stats-json", "-o", str(tmp_path / "x.png")]) == 0
    assert json.loads(capsys.readouterr().out)["spp"] == spp


# --- the port's CLI ----------------------------------------------------------------

def test_cli_hdr_equals_the_in_process_renderer(tmp_path, capsys):
    """--device cpu, 32x18, 4 spp in frames of 2, 4 bounces ("auto":
    regroup's twins): the PNG is written and --hdr holds the in-process
    Renderer's mean radiance in every bit."""
    png, hdr = tmp_path / "out.png", tmp_path / "out.npz"
    assert tcli.main(["--device", "cpu", "--scene", "three", "--size", "32x18", "--spp", "4",
                      "--spp-per-frame", "2", "--bounces", "4", "--stats-json",
                      "--hdr", str(hdr), "-o", str(png)]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["backend"] == "regroup" and line["devices"] == 1 and line["spp"] == 4
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    params = twrt.RenderParams(camera=tscenes.three_spheres_camera(), viewport_size=(32, 18),
                               sampling=twrt.SamplingParams(max_samples_per_pixel=4,
                                                            num_samples_per_pixel=2,
                                                            num_bounces=4))
    r = twrt.Renderer(tscenes.three_spheres(), params, device="cpu")
    r.render()
    with np.load(hdr) as data:
        assert int(data["samples"]) == 4
        np.testing.assert_array_equal(data["mean_radiance"], r.mean_radiance().numpy())


def test_cli_json_line_has_the_jax_keys(tmp_path, capsys):
    """Both CLIs with --backend xla at 16x8, 1 spp, 2 bounces: the same JSON
    keys and the same values but for times and paths; the two images agree
    at test_torch_xla.py's tolerance (close share > 0.98, RMSE on the close
    pixels < 1e-4, tonemapped RMSE < 5e-3, mean within a relative 1e-3)."""
    lines, means = {}, {}
    for pkg, mod in CLIS.items():
        args = ["--scene", "three", "--size", "16x8", "--spp", "1", "--bounces", "2",
                "--backend", "xla", "--stats-json", "-o", str(tmp_path / f"{pkg}.png"),
                "--hdr", str(tmp_path / f"{pkg}.npz")]
        assert mod.main(args + (["--device", "cpu"] if pkg == "torch" else [])) == 0
        lines[pkg] = json.loads(capsys.readouterr().out)
        with np.load(tmp_path / f"{pkg}.npz") as data:
            means[pkg] = data["mean_radiance"]
    assert list(lines["torch"]) == list(lines["jax"])
    for key in ("scene", "backend", "size", "spp", "devices", "sky"):
        assert lines["torch"][key] == lines["jax"][key], key
    got, want = means["torch"], means["jax"]
    assert got.shape == want.shape == (8, 16, 3) and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-2, atol=1e-3).all(axis=-1)
    assert close.mean() > 0.98
    assert np.sqrt(((got[close] - want[close]) ** 2).mean()) < 1e-4
    tm = [np.asarray(to_srgb_u8(jnp.asarray(a))).astype(np.float32) / 255 for a in (got, want)]
    assert np.sqrt(((tm[0] - tm[1]) ** 2).mean()) < 5e-3
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-3


def test_cli_needs_a_card_for_cuda(capsys):
    """The default --device cuda without a card is an error, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tcli.main(["--scene", "three", "--size", "8x4", "--spp", "1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_mesh_outside_a_world_is_refused(tmp_path):
    """Two tile shards with no torchrun world around the CLI: the mesh of
    the one local rank cannot hold them, so the run raises instead of
    rendering the whole image on one rank."""
    with pytest.raises(RenderParamsValidationError):
        tcli.main(["--device", "cpu", "--scene", "three", "--size", "8x4", "--spp", "1",
                   "--tile-shards", "2", "-o", str(tmp_path / "x.png")])
