"""PSNR parity vs REAL GL (Mesa llvmpipe via native/gloracle).

The BASELINE acceptance test: Engine output vs the actual GL compiler +
rasterizer on the same preset, input, parameters, and frame count.
Presets whose math is separable come out bit-exact; warped ones land
far above the 50 dB bar. crt-mattias's 25% `fract(sin(x)*43758)` noise
hash is chaotic under last-ulp sin differences (any two GL drivers
disagree there too), so it is asserted at its no-noise bound separately.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from retrocapture_tpu import Engine
from retrocapture_tpu.io.testpattern import TestPatternSource

SH = "/root/reference/shaders/shaders_glsl/"
ORACLE_BIN = Path(__file__).resolve().parents[1] / "native" / "gloracle" / "gloracle"


def _have_oracle() -> bool:
    if ORACLE_BIN.is_file():
        return True
    if shutil.which("g++") is None:
        return False
    try:
        subprocess.run(
            ["make", "-C", str(ORACLE_BIN.parent)],
            check=True,
            capture_output=True,
            timeout=180,
        )
    except Exception:
        return False
    return ORACLE_BIN.is_file()


pytestmark = [
    pytest.mark.oracle,
    pytest.mark.skipif(
        not _have_oracle(), reason="gloracle (software GL) unavailable"
    ),
]


@pytest.fixture(scope="module")
def frame():
    return TestPatternSource(320, 240).capture_frame()


def run_pair(preset: str, frame, viewport=(640, 480), n_frames=1, params=None):
    from retrocapture_tpu.parity import OracleEngine, psnr

    o = OracleEngine(viewport=viewport)
    assert o.load_preset(preset)
    e = Engine(viewport=viewport)
    assert e.load_preset(preset), e.last_error
    for name, val in (params or {}).items():
        o.set_parameter(name, val)
        e.set_parameter(name, val)
    gl = ours = None
    for _ in range(n_frames):
        gl = o.apply(frame)
        ours = np.asarray(e.apply(frame))
    return psnr(gl, ours)


def test_stock_bit_exact(frame):
    p = run_pair(SH + "stock.glsl", frame)
    assert p == float("inf"), p


def test_scanline_preset(frame):
    p = run_pair(SH + "interpolation/sharp-bilinear-scanlines.glslp", frame)
    assert p >= 50.0, p


def test_xbr_lv2(frame):
    p = run_pair(SH + "xbr/xbr-lv2.glslp", frame)
    assert p >= 50.0, p


def test_crt_mattias_no_noise(frame, tmp_path):
    src = Path(SH + "crt/shaders/crt-mattias.glsl").read_text()
    noise_line = next(l for l in src.splitlines() if "0.25*vec3( rand" in l)
    (tmp_path / "mattias_nonoise.glsl").write_text(src.replace(noise_line, ""))
    p = run_pair(str(tmp_path / "mattias_nonoise.glsl"), frame)
    assert p >= 50.0, p


def test_crt_mattias_with_noise_documented_floor(frame):
    """With the chaotic hash noise the achievable parity is fp-bounded;
    assert it stays above a floor so regressions are still caught."""
    p = run_pair(SH + "crt/crt-mattias.glslp", frame)
    assert p >= 30.0, p


def test_ntsc_two_pass_temporal(frame):
    p = run_pair(SH + "ntsc/ntsc-320px.glslp", frame, n_frames=3)
    assert p >= 50.0, p


def test_hyllian_glow_chain(frame):
    p = run_pair(SH + "crt/crt-hyllian-glow.glslp", frame)
    assert p >= 50.0, p


def test_parameter_override_parity(frame):
    p = run_pair(
        SH + "crt/crt-mattias.glslp",
        frame,
        params={"CURVATURE": 0.0},
    )
    assert p >= 30.0, p


def test_crt_royale(frame):
    """The largest named CRT family in the corpus (12 presets): its
    cg-style alias-prefixed size uniforms and 2,756-line include headers
    exercise the preprocessor+binding model end to end
    (shaders_glsl/crt/shaders/crt-royale/)."""
    p = run_pair(SH + "crt/crt-royale.glslp", frame, n_frames=2)
    assert p >= 40.0, p
