"""The port's command-line decoder, `python -m j40_tpu_torch`, against the
JAX package's (`python -m j40_tpu`) on the same seeded streams.

The port's CLI runs here with `--device cpu` (every kernel site through its
plain version) and writes PNG through `j40_tpu_torch.png`; the JAX CLI
writes through Pillow, which also reads both.  Tolerances: Modular and the
host plan (`--backend numpy`) bit-exact; VarDCT on `--backend torch`
within 1 gray level of JAX's `--backend jax` (fp32 sums in another order,
the bar of tests/test_torch_combine.py).  Runs where the exit code or
stderr is the point run in a subprocess; the rest call `main` in-process.
"""

import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from j40_tpu.__main__ import main as jax_main
from j40_tpu_torch import png
from j40_tpu_torch.__main__ import main as torch_main
from j40_tpu_torch.encode.encoder import encode_animation, encode_modular
from j40_tpu_torch.encode.vardct_enc import VarDCTOptions, encode_vardct
from j40_tpu_torch.io.container import FTYP_BOX, JXL_BOX

ROOT = Path(__file__).resolve().parents[1]


def _noise(rng, h, w):
    return (np.cumsum(np.cumsum(rng.integers(-2, 3, size=(h, w, 3)), 0), 1)
            % 200 + 20).astype(np.uint8)


def _box(type_: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + type_ + payload


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """Seeded inputs: a 32x24 RGB Modular stream (and its pixels), an 80x64
    VarDCT stream with custom EPF (so --filters moves pixels), a 20x12 RGBA
    Modular stream bare and in a container, and a 3-frame animation."""
    d = tmp_path_factory.mktemp("cli_streams")
    rng = np.random.default_rng(50)
    img = rng.integers(0, 256, size=(24, 32, 3), dtype=np.uint8)
    rgba = np.concatenate([_noise(rng, 12, 20), rng.integers(0, 256, (12, 20, 1),
                                                             dtype=np.uint8)], 2)
    cs = encode_modular(rgba)
    frames = [(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8), t) for t in (2, 3, 1)]
    files = {
        "modular": encode_modular(img),
        "vardct": encode_vardct(_noise(rng, 64, 80), VarDCTOptions(
            sharpness=5, custom_restoration=True, epf_iters=2)),
        "rgba": cs,
        "container": JXL_BOX + FTYP_BOX + _box(b"jxlc", cs),
        "anim": encode_animation(frames, tps=(10, 1), num_loops=3),
    }
    paths = {}
    for k, v in files.items():
        paths[k] = d / f"{k}.jxl"
        paths[k].write_bytes(v)
    paths["modular_pixels"] = img
    return paths


def _read(path) -> np.ndarray:
    return np.asarray(PILImage.open(path).convert("RGBA"))


def _frames(path) -> tuple[list[np.ndarray], list[float], int]:
    """Every frame of an APNG as Pillow reads it, their durations and the
    loop count."""
    im = PILImage.open(path)
    out, durs = [], []
    for i in range(im.n_frames):
        im.seek(i)
        out.append(np.asarray(im.convert("RGBA")))
        durs.append(im.info["duration"])
    return out, durs, im.info["loop"]


def _port(args, **kw):
    return subprocess.run([sys.executable, "-m", "j40_tpu_torch", *map(str, args)],
                          capture_output=True, text=True, cwd=str(ROOT), timeout=300, **kw)


def test_modular_png_bit_exact(streams, tmp_path, capsys):
    """A 32x24 RGB Modular stream: the port's PNG equals the source and the
    JAX CLI's PNG, and the stderr lines match JAX's."""
    a, b = tmp_path / "port.png", tmp_path / "jax.png"
    assert torch_main([str(streams["modular"]), str(a), "--device", "cpu"]) == 0
    port_err = capsys.readouterr().err
    assert jax_main([str(streams["modular"]), str(b)]) == 0
    assert port_err == capsys.readouterr().err == "32x24 read (1 frame).\n"
    got = _read(a)
    np.testing.assert_array_equal(got[:, :, :3], streams["modular_pixels"])
    assert (got[:, :, 3] == 255).all()
    np.testing.assert_array_equal(got, _read(b))


@pytest.mark.parametrize("filters", [False, True], ids=["plain", "filters"])
def test_vardct_torch_within_one_level_of_jax(streams, tmp_path, filters):
    """--backend torch (the default) against JAX's --backend jax."""
    a, b = tmp_path / "port.png", tmp_path / "jax.png"
    extra = ["--filters"] * filters
    assert torch_main([str(streams["vardct"]), str(a), "--device", "cpu", *extra]) == 0
    assert jax_main([str(streams["vardct"]), str(b), "--backend", "jax", *extra]) == 0
    got, want = _read(a), _read(b)
    assert got.shape == want.shape == (64, 80, 4)
    assert int(np.abs(got.astype(np.int16) - want).max()) <= 1


@pytest.mark.parametrize("filters", [False, True], ids=["plain", "filters"])
def test_vardct_numpy_equals_jax_numpy(streams, tmp_path, filters):
    """--backend numpy (the host plan) is bit-exact with JAX's."""
    a, b = tmp_path / "port.png", tmp_path / "jax.png"
    extra = ["--backend", "numpy"] + ["--filters"] * filters
    assert torch_main([str(streams["vardct"]), str(a), *extra]) == 0
    assert jax_main([str(streams["vardct"]), str(b), *extra]) == 0
    np.testing.assert_array_equal(_read(a), _read(b))


def test_filters_change_the_output(streams, tmp_path):
    """The --filters flag reaches the decoder (the stream's EPF moves
    pixels)."""
    a, b = tmp_path / "plain.png", tmp_path / "filtered.png"
    assert torch_main([str(streams["vardct"]), str(a), "--device", "cpu"]) == 0
    assert torch_main([str(streams["vardct"]), str(b), "--device", "cpu", "--filters"]) == 0
    assert not np.array_equal(_read(a), _read(b))


@pytest.mark.parametrize("kind", ["rgba", "container", "anim"])
def test_info_equals_jax(streams, capsys, kind):
    """--info prints JAX's text, character for character."""
    assert torch_main([str(streams[kind]), "--info"]) == 0
    port = capsys.readouterr().out
    assert jax_main([str(streams[kind]), "--info"]) == 0
    assert port == capsys.readouterr().out
    want = {"rgba": "JPEG XL bare codestream", "container": "JPEG XL container",
            "anim": "JPEG XL bare codestream"}[kind]
    assert port.startswith(want) and ("extra channel 0: alpha" in port) == (kind != "anim")


def _error_line(err: str) -> str:
    return next(ln for ln in err.splitlines() if ln.startswith("Error:"))


@pytest.mark.parametrize("case", ["missing", "corrupt"])
def test_errors_as_jax(tmp_path, capsys, case):
    """A missing file and a corrupt input: rc 1 and JAX's message."""
    src = tmp_path / "bad.jxl"
    if case == "corrupt":
        src.write_bytes(b"\xff\x0a" + b"\x00" * 16)
    out = tmp_path / "o.png"
    r = _port([src, out, "--device", "cpu"])
    assert jax_main([str(src), str(out)]) == 1
    want = capsys.readouterr().err.strip()
    assert r.returncode == 1 and _error_line(r.stderr) == want
    assert want.startswith({"missing": "Error: cannot open", "corrupt":
                            "Error: failed to decode"}[case])
    assert not out.exists()


def test_all_frames_apng_equals_jax(streams, tmp_path, capsys):
    """--all-frames to .apng: 3 frames whose pixels, durations and loop count
    (read by Pillow) equal the JAX CLI's APNG."""
    a, b = tmp_path / "port.apng", tmp_path / "jax.apng"
    assert torch_main([str(streams["anim"]), str(a), "--all-frames", "--device", "cpu"]) == 0
    assert jax_main([str(streams["anim"]), str(b), "--all-frames"]) == 0
    assert "16x16 read (3 frames)." in capsys.readouterr().err
    got, want = _frames(a), _frames(b)
    assert len(got[0]) == len(want[0]) == 3
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1] == want[1] == [200.0, 300.0, 100.0]
    assert got[2] == want[2] == 3


def test_all_frames_numbered_pngs_equal_jax(streams, tmp_path):
    """--all-frames to a name that is not .apng: one `stem-NNN.png` a frame."""
    assert torch_main([str(streams["anim"]), str(tmp_path / "p.png"), "--all-frames",
                       "--device", "cpu"]) == 0
    assert jax_main([str(streams["anim"]), str(tmp_path / "j.png"), "--all-frames"]) == 0
    names = sorted(p.name for p in tmp_path.glob("p-*.png"))
    assert names == ["p-000.png", "p-001.png", "p-002.png"]
    for n in names:
        np.testing.assert_array_equal(_read(tmp_path / n),
                                      _read(tmp_path / n.replace("p-", "j-")))


def test_profile_writes_a_trace(streams, tmp_path, capsys):
    """--profile DIR writes one torch.profiler trace that names aten ops, and
    the decode's lines as without it."""
    prof = tmp_path / "prof"
    assert torch_main([str(streams["vardct"]), str(tmp_path / "o.png"), "--device", "cpu",
                       "--time", "--profile", str(prof)]) == 0
    err = capsys.readouterr().err
    assert "80x64 read (1 frame)." in err and "decoded in " in err
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = [e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]]
    assert any(n.startswith("aten::") for n in names)


def test_stats_and_time_lines(streams, tmp_path, capsys):
    """--time and --stats print JAX's lines (the stage names of dec.stats)."""
    assert torch_main([str(streams["vardct"]), "--device", "cpu", "--time", "--stats"]) == 0
    err = capsys.readouterr().err
    assert jax_main([str(streams["vardct"]), "--backend", "numpy", "--time", "--stats"]) == 0
    jerr = capsys.readouterr().err
    keys = lambda e: [ln.split(":")[0].strip() for ln in e.splitlines() if ln.startswith("  ")]
    assert {"headers_s", "sections_s", "reconstruct_s", "total_s"} <= set(keys(err))
    assert err.splitlines()[0] == jerr.splitlines()[0] == "80x64 read (1 frame)."
    assert "Mpix/s)" in err.splitlines()[1]


def test_stats_print_the_spans(streams, capsys):
    """--stats prints each span of the decode as `name  ms  self-ms`, one
    line each under the root `request`, not the raw records."""
    assert torch_main([str(streams["modular"]), "--device", "cpu", "--backend", "device",
                       "--stats"]) == 0
    err = capsys.readouterr().err.splitlines()
    at = err.index("  spans (name, ms, self ms):")
    rows = [ln.split() for ln in err[at + 1:]]
    assert rows and rows[0][0] == "request" and err[at + 1].startswith("    request  ")
    names = [r[0] for r in rows]
    assert names == ["request", "headers", "sections", "finish", "render"]  # one section
    for r in rows:
        assert len(r) == 3 and 0 <= float(r[2]) <= float(r[1])
    assert not any(ln.lstrip().startswith("spans:") for ln in err)


def test_no_cuda_stops_and_writes_nothing(streams, tmp_path):
    """Without a CUDA device and without --device cpu the CLI stops: rc 1,
    stderr names CUDA, no output file; --info needs no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    out = tmp_path / "o.png"
    r = _port([streams["vardct"], out])
    assert r.returncode == 1 and "CUDA" in r.stderr, r.stderr
    assert not out.exists()
    r = _port([streams["vardct"], "--info"])
    assert r.returncode == 0 and "image: 80x64" in r.stdout, r.stderr


def test_unknown_backend_refused(streams, capsys):
    """The port's backends only: JAX's "jax" and "auto" are refused."""
    for b in ("jax", "auto"):
        with pytest.raises(SystemExit) as e:
            torch_main([str(streams["vardct"]), "--backend", b])
        assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 4), dtype=np.uint8)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (37, 19)], ids=lambda s: f"{s[1]}x{s[0]}")
def test_write_png_round_trip(tmp_path, shape):
    """png.write_png through Pillow, bit for bit."""
    img = _image(np.random.default_rng(shape[0] * 100 + shape[1]), *shape)
    png.write_png(tmp_path / "x.png", img)
    im = PILImage.open(tmp_path / "x.png")
    assert im.mode == "RGBA"
    np.testing.assert_array_equal(np.asarray(im), img)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (37, 19)], ids=lambda s: f"{s[1]}x{s[0]}")
def test_write_apng_round_trip(tmp_path, shape):
    """png.write_apng through Pillow: frames, delays and loop count."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1] + 7)
    imgs = [_image(rng, *shape) for _ in range(3)]
    png.write_apng(tmp_path / "x.apng", imgs, [40, 1, 65535], loops=5)
    got, durs, loop = _frames(tmp_path / "x.apng")
    assert len(got) == 3 and durs == [40.0, 1.0, 65535.0] and loop == 5
    for g, w in zip(got, imgs):
        np.testing.assert_array_equal(g, w)


def test_png_writer_refuses_bad_input(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(tmp_path / "x.png", np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="65536"):
        png.write_apng(tmp_path / "x.apng", [np.zeros((2, 2, 4), np.uint8)], [70000], 0)


@pytest.mark.parametrize("shape", [(1, 1), (37, 19), (64, 96)], ids=lambda s: f"{s[1]}x{s[0]}")
def test_chip_smoke_reader(tmp_path, shape):
    """chip_smoke.read_png (the card machine has no Pillow) reads Pillow's
    PNGs, whose rows take every filter type, and png.write_apng's APNGs."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    rng = np.random.default_rng(3)
    h, w = shape
    img = np.concatenate([_noise(rng, h, w), rng.integers(200, 256, (h, w, 1),
                                                          dtype=np.uint8)], 2)
    img[: h // 2] = rng.integers(0, 256, (h // 2, w, 4), dtype=np.uint8)
    PILImage.fromarray(img, "RGBA").save(tmp_path / "p.png")
    (got,), delays, loops = chip_smoke.read_png(tmp_path / "p.png")
    np.testing.assert_array_equal(got, img)
    assert delays == [] and loops is None
    png.write_apng(tmp_path / "a.apng", [img, img[::-1].copy()], [20, 30], loops=4)
    frames, delays, loops = chip_smoke.read_png(tmp_path / "a.apng")
    np.testing.assert_array_equal(frames[0], img)
    np.testing.assert_array_equal(frames[1], img[::-1])
    assert delays == [20.0, 30.0] and loops == 4
