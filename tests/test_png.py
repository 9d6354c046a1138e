"""The stdlib PNG reader for LUT textures (graph/plan._load_png_rgba).

PNG files are written here with zlib + struct, each scanline under one
of the five filter types in turn, so the reader's unfiltering is checked
against pixels the test chose. A LUT preset also loads with Pillow made
unimportable.
"""

import struct
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest

from retrocapture_tpu.graph.plan import PresetCompileError, _load_png_rgba

REPO = Path(__file__).resolve().parents[1]


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (
        struct.pack(">I", len(body))
        + ctype
        + body
        + struct.pack(">I", zlib.crc32(ctype + body))
    )


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(ftype: int, row: bytes, prior: bytes, bpp: int) -> bytes:
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def write_png(path, pixels: np.ndarray, color: int, *, palette=None, trns=None,
              depth: int = 8, interlace: int = 0) -> None:
    """pixels: uint8 [H, W, C] (C = samples per pixel of ``color``)."""
    h, w = pixels.shape[:2]
    bpp = pixels.shape[2]
    raw, prior = bytearray(), bytes(w * bpp)
    for y in range(h):
        row = pixels[y].tobytes()
        ftype = y % 5
        raw += bytes([ftype]) + _filter_row(ftype, row, prior, bpp)
        prior = row
    data = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    )
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns.astype(np.uint8).tobytes())
    data += _chunk(b"IDAT", zlib.compress(bytes(raw)))
    data += _chunk(b"IEND", b"")
    Path(path).write_bytes(data)


def _rgba_of(kind, px, palette=None, trns=None):
    h, w = px.shape[:2]
    full = np.full((h, w, 1), 255, np.uint8)
    if kind == "gray":
        return np.concatenate([px, px, px, full], -1)
    if kind == "gray_alpha":
        g = px[..., :1]
        return np.concatenate([g, g, g, px[..., 1:]], -1)
    if kind == "rgb":
        return np.concatenate([px, full], -1)
    if kind == "rgba":
        return px
    alpha = np.full(len(palette), 255, np.uint8)
    if trns is not None:
        alpha[: len(trns)] = trns
    return np.concatenate([palette, alpha[:, None]], 1)[px[..., 0]]


CASES = {
    "gray": (0, 1),
    "gray_alpha": (4, 2),
    "rgb": (2, 3),
    "rgba": (6, 4),
    "palette": (3, 1),
    "palette_trns": (3, 1),
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_png_roundtrip(tmp_path, kind):
    color, ch = CASES[kind]
    rng = np.random.default_rng(len(kind))
    h, w = 11, 13
    palette = trns = None
    if color == 3:
        palette = rng.integers(0, 256, (20, 3)).astype(np.uint8)
        px = rng.integers(0, 20, (h, w, 1)).astype(np.uint8)
        if kind == "palette_trns":
            trns = rng.integers(0, 256, 7).astype(np.uint8)
    else:
        px = rng.integers(0, 256, (h, w, ch)).astype(np.uint8)
    p = tmp_path / f"{kind}.png"
    write_png(p, px, color, palette=palette, trns=trns)
    got = _load_png_rgba(str(p))
    want = _rgba_of(kind, px, palette, trns).astype(np.float32) / 255.0
    assert got.dtype == np.float32 and got.shape == (h, w, 4)
    assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "kwargs,what",
    [
        ({"depth": 16}, "bit depth 16"),
        ({"interlace": 1}, "interlace 1"),
        ({"depth": 4, "color": 3}, "bit depth 4"),
    ],
)
def test_png_unsupported_raises_clear_error(tmp_path, kwargs, what):
    p = tmp_path / "bad.png"
    color = kwargs.pop("color", 2)
    px = np.zeros((4, 4, 1 if color == 3 else 3), np.uint8)
    pal = np.zeros((2, 3), np.uint8) if color == 3 else None
    write_png(p, px, color, palette=pal, **kwargs)
    with pytest.raises(PresetCompileError, match=what):
        _load_png_rgba(str(p))


_LUT_SHADER = """
#if defined(VERTEX)
attribute vec4 VertexCoord; attribute vec4 TexCoord; varying vec2 vTexCoord;
uniform mat4 MVPMatrix;
void main() { gl_Position = MVPMatrix * VertexCoord; vTexCoord = TexCoord.xy; }
#elif defined(FRAGMENT)
varying vec2 vTexCoord;
uniform sampler2D Texture;
uniform sampler2D LUT;
void main() {
    float g = texture2D(Texture, vTexCoord).g;
    gl_FragColor = texture2D(LUT, vec2(g * 0.75 + 0.125, 0.5));
}
#endif
"""


def test_lut_preset_loads_without_pillow(tmp_path):
    """Importing the package and running a LUT preset needs no Pillow:
    the child process makes ``PIL`` unimportable before the import."""
    lut = np.array([[[255, 0, 0], [0, 255, 0], [0, 0, 255], [9, 9, 9]]], np.uint8)
    write_png(tmp_path / "lut.png", lut, 2)
    (tmp_path / "lut.glsl").write_text(_LUT_SHADER)
    (tmp_path / "lut.glslp").write_text(
        "shaders = 1\nshader0 = lut.glsl\nfilter_linear0 = false\n"
        'textures = "LUT"\nLUT = lut.png\nLUT_linear = false\n'
    )
    code = textwrap.dedent(
        f"""
        import sys
        sys.modules["PIL"] = None
        import numpy as np
        import jax
        jax.config.update("jax_platforms", "cpu")
        from retrocapture_tpu import Engine
        e = Engine()
        assert e.load_preset({str(tmp_path / 'lut.glslp')!r}), e.last_error
        frame = np.zeros((4, 8, 3), np.uint8)
        frame[:, 4:, 1] = 255  # green 0 -> LUT texel 0, green 1 -> texel 3
        out = np.asarray(e.apply(frame))
        assert e.shader_active, e.last_error
        assert np.allclose(out[0, 0], [1, 0, 0]), out[0, 0]
        assert np.allclose(out[0, 7], [9 / 255] * 3), out[0, 7]
        assert "PIL.Image" not in sys.modules
        print("ok")
        """
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=str(REPO), timeout=300,
    )
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]


def test_thumbnail_without_pillow_raises_clear_error(tmp_path, monkeypatch):
    from retrocapture_tpu.utils.thumbnails import generate_preset_thumbnail

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        generate_preset_thumbnail(
            REPO / "assets/presets/feedback-ghost.glslp", tmp_path / "t.png"
        )
