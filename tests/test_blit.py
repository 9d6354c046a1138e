"""The final viewport blit (ops/sampling.resize_linear) against a float64
numpy reference.

Reference semantics: OpenGLRenderer::renderTexture stretches the last
pass output to the viewport with the FBO texture's LINEAR filter and
clamp_to_edge (src/renderer/OpenGLRenderer.cpp:389-463). The blit must
equal the f64 two-tap lerp quantized to u8 everywhere except where the
exact value sits on a u8 rounding knife edge, and there by at most one
step.
"""

import numpy as np
import pytest

from retrocapture_tpu.ops.sampling import resize_linear


def _axis_taps(n_src: int, n_dst: int):
    """Texel-centered LINEAR taps with the sampler's float32 coordinate
    math: (i0, i1, fx) per output index."""
    c = ((np.arange(n_dst, dtype=np.float64) + 0.5) / n_dst).astype(np.float32)
    x = c * np.float32(n_src) - np.float32(0.5)
    x0 = np.floor(x)
    fx = (x - x0).astype(np.float64)
    x0 = x0.astype(np.int64)
    return np.clip(x0, 0, n_src - 1), np.clip(x0 + 1, 0, n_src - 1), fx


def _reference(tex: np.ndarray, ow: int, oh: int) -> np.ndarray:
    t = tex.astype(np.float64)
    i0, i1, f = _axis_taps(t.shape[0], oh)
    t = t[i0] * (1.0 - f)[:, None, None] + t[i1] * f[:, None, None]
    i0, i1, f = _axis_taps(t.shape[1], ow)
    return t[:, i0] * (1.0 - f)[None, :, None] + t[:, i1] * f[None, :, None]


def _mk_tex(rng, h, w, c=3):
    # Half exact u8-grid values: they land on n/255 so a 1-ulp resample
    # difference flips the rounded output (the knife-edge class).
    t = rng.random((h, w, c)).astype(np.float32)
    grid = (rng.integers(0, 256, size=(h, w, c)) / 255.0).astype(np.float32)
    return np.where(rng.random((h, w, c)) < 0.5, grid, t).astype(np.float32)


# (src_w, dst_w, src_h, dst_h): 320->1920 is the 6x x-upscale of every
# chain with a 320-wide last pass at a 1080p viewport, 640->1920 the 3x
# of chains that double x, plus y-identity, odd heights, a small 2x,
# identity-identity (quantize only) and a downscale.
GEOMETRIES = [
    pytest.param(320, 1920, 240, 1080, id="r6-with-y"),
    pytest.param(640, 1920, 240, 1080, id="r3-with-y"),
    pytest.param(320, 1920, 240, 240, id="r6-y-identity"),
    pytest.param(640, 1920, 333, 333, id="r3-y-identity-odd"),
    pytest.param(320, 1920, 240, 1077, id="r6-odd-oh"),
    pytest.param(128, 256, 96, 192, id="r2-small"),
    pytest.param(64, 64, 48, 48, id="identity-identity"),
    pytest.param(200, 120, 150, 90, id="downscale"),
]


@pytest.mark.parametrize("w,ow,h,oh", GEOMETRIES)
def test_blit_matches_f64_reference(w, ow, h, oh):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(w * 7 + ow + h)
    tex = _mk_tex(rng, h, w)
    out = jax.jit(lambda t: resize_linear(t, ow, oh))(jnp.asarray(tex))
    got = np.asarray(out)
    assert got.shape == (oh, ow, 3) and got.dtype == np.float32

    exact = _reference(tex, ow, oh)
    np.testing.assert_allclose(got, exact, rtol=0, atol=2e-7)
    if (w, h) == (ow, oh):
        assert np.array_equal(got, tex)  # identity axes are skipped

    scaled = np.clip(exact, 0.0, 1.0) * 255.0
    q64 = np.round(scaled).astype(np.int32)
    q = np.round(np.clip(got, 0.0, 1.0) * 255.0).astype(np.int32)
    diff = np.abs(q - q64)
    edge = np.abs(scaled - np.floor(scaled) - 0.5) < 1e-4
    assert diff.max() <= 1
    assert (diff[~edge] == 0).all(), f"{int((diff[~edge] != 0).sum())} off-edge"


def test_blit_batched_leading_axes():
    """[B, H, W, C] blits every frame like the single-frame call."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    frames = rng.random((3, 24, 32, 3)).astype(np.float32)
    batched = np.asarray(resize_linear(jnp.asarray(frames), 96, 54))
    assert batched.shape == (3, 54, 96, 3)
    for i in range(3):
        one = np.asarray(resize_linear(jnp.asarray(frames[i]), 96, 54))
        assert np.array_equal(batched[i], one)
