"""Fuzz sample2d against the NumPy GL-reference oracle (SURVEY.md §7
step 4: "this gates everything")."""

import numpy as np
import pytest

from retrocapture_tpu.ops.sampling import (
    WRAP_MODES,
    reference_sample2d_numpy,
    sample2d,
)


@pytest.mark.parametrize("wrap", WRAP_MODES)
@pytest.mark.parametrize("linear", [False, True])
def test_fuzz_vs_oracle(wrap, linear):
    rng = np.random.default_rng(hash((wrap, linear)) % 2**32)
    tex = rng.random((13, 17, 4), np.float32)
    # Include exact texel centers/edges and far out-of-range coords.
    u = np.concatenate(
        [
            rng.uniform(-2.0, 3.0, 500),
            np.linspace(0, 1, 18),  # edges
            (np.arange(17) + 0.5) / 17,  # centers
        ]
    ).astype(np.float32)
    v = np.concatenate(
        [
            rng.uniform(-2.0, 3.0, 500),
            np.linspace(0, 1, 18),
            (np.arange(17) + 0.5)[:1].repeat(18) / 13,
        ]
    ).astype(np.float32)
    n = min(len(u), len(v))
    u, v = u[:n], v[:n]
    got = np.asarray(sample2d(tex, u, v, filter_linear=linear, wrap_mode=wrap))
    want = reference_sample2d_numpy(tex, u, v, filter_linear=linear, wrap_mode=wrap)
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_nearest_exact_center_hits_texel():
    tex = np.arange(12, dtype=np.float32).reshape(3, 4, 1)
    u = (np.arange(4) + 0.5) / 4.0
    v = np.full(4, 0.5 / 3.0, np.float32)
    got = np.asarray(sample2d(tex, u, v, filter_linear=False))
    np.testing.assert_array_equal(got[:, 0], [0, 1, 2, 3])


def test_bilinear_at_center_is_exact():
    rng = np.random.default_rng(0)
    tex = rng.random((8, 8, 3), np.float32)
    u = (np.arange(8) + 0.5) / 8.0
    v = np.full(8, (2 + 0.5) / 8.0, np.float32)
    got = np.asarray(sample2d(tex, u, v, filter_linear=True))
    np.testing.assert_allclose(got, tex[2], atol=1e-6)


def test_bilinear_midpoint_average():
    tex = np.zeros((1, 2, 1), np.float32)
    tex[0, 0, 0] = 0.0
    tex[0, 1, 0] = 1.0
    got = np.asarray(sample2d(tex, np.float32(0.5), np.float32(0.5), filter_linear=True))
    np.testing.assert_allclose(got, [0.5], atol=1e-6)


def test_border_returns_zero():
    tex = np.ones((4, 4, 4), np.float32)
    got = np.asarray(
        sample2d(
            tex,
            np.float32(-0.5),
            np.float32(0.5),
            filter_linear=False,
            wrap_mode="clamp_to_border",
        )
    )
    np.testing.assert_array_equal(got, [0, 0, 0, 0])


def test_repeat_tiles():
    tex = np.arange(4, dtype=np.float32).reshape(1, 4, 1)
    got = np.asarray(
        sample2d(
            tex,
            np.float32(1.0 + 0.5 / 4),
            np.float32(0.5),
            filter_linear=False,
            wrap_mode="repeat",
        )
    )
    np.testing.assert_array_equal(got, [0.0])


def test_grid_shaped_coords():
    rng = np.random.default_rng(1)
    tex = rng.random((6, 5, 4), np.float32)
    u = rng.random((7, 9), np.float32)
    v = rng.random((7, 9), np.float32)
    got = np.asarray(sample2d(tex, u, v, filter_linear=True))
    assert got.shape == (7, 9, 4)
    want = reference_sample2d_numpy(
        tex, u, v, filter_linear=True, wrap_mode="clamp_to_edge"
    )
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_separable_traced_matches_oracle_all_modes():
    """sample2d_separable (traced per-axis vectors -> on-device matmuls)
    matches the NumPy GL oracle for every (filter, wrap) combination,
    including out-of-range coords."""
    import jax.numpy as jnp

    from retrocapture_tpu.ops.sampling import sample2d_separable

    rng = np.random.default_rng(7)
    tex = rng.random((11, 13, 4)).astype(np.float32)
    u_row = (rng.random(17).astype(np.float32) * 2.4 - 0.7)
    v_col = (rng.random(9).astype(np.float32) * 2.4 - 0.7)
    uu = np.broadcast_to(u_row[None, :], (9, 17))
    vv = np.broadcast_to(v_col[:, None], (9, 17))
    for wrap in ("clamp_to_edge", "clamp_to_border", "repeat", "mirrored_repeat"):
        for lin in (False, True):
            got = np.asarray(
                sample2d_separable(
                    jnp.asarray(tex),
                    jnp.asarray(u_row),
                    jnp.asarray(v_col),
                    filter_linear=lin,
                    wrap_mode=wrap,
                )
            )
            want = reference_sample2d_numpy(
                tex, uu, vv, filter_linear=lin, wrap_mode=wrap
            )
            np.testing.assert_allclose(got, want, atol=3e-6, err_msg=f"{wrap} lin={lin}")


def test_deps_metadata_drives_separable_sampling():
    """A floor/fract-sharpened tap (non-affine, per-axis) must keep
    axis-dependence metadata and produce the same pixels as the generic
    warp path — engine-level guard for the deps fast path."""
    from retrocapture_tpu.runtime.engine import Engine

    src = """
#if defined(VERTEX)
attribute vec4 VertexCoord; attribute vec4 TexCoord; varying vec4 TEX0;
void main() { gl_Position = VertexCoord; TEX0 = TexCoord; }
#elif defined(FRAGMENT)
uniform sampler2D Texture; varying vec4 TEX0;
uniform vec2 TextureSize;
void main() {
    vec2 texel = TEX0.xy * TextureSize;
    vec2 tf = floor(texel);
    vec2 s = fract(texel);
    vec2 f = clamp(s * 2.0 - 0.5, 0.0, 1.0);
    vec2 mod_texel = tf + f;
    gl_FragColor = texture2D(Texture, mod_texel / TextureSize);
}
#endif
"""
    import tempfile, os

    rng = np.random.default_rng(5)
    frame = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "sharp.glsl")
        open(p, "w").write(src)
        pp = os.path.join(td, "sharp.glslp")
        open(pp, "w").write(f"shaders = 1\nshader0 = {p}\nfilter_linear0 = true\n")
        e = Engine(viewport=(64, 48))
        assert e.load_preset(pp), e.last_error
        out = np.asarray(e.apply(frame))
    # Oracle: same math in NumPy against the reference sampler.
    u = (np.arange(64, dtype=np.float32) + 0.5) / 64
    v = (np.arange(48, dtype=np.float32) + 0.5) / 48
    uu, vv = np.meshgrid(u, v)
    tx, ty = uu * 32, vv * 24
    fx = np.floor(tx) + np.clip((tx - np.floor(tx)) * 2 - 0.5, 0, 1)
    fy = np.floor(ty) + np.clip((ty - np.floor(ty)) * 2 - 0.5, 0, 1)
    texf = np.concatenate(
        [frame.astype(np.float32) / 255.0, np.ones((24, 32, 1), np.float32)], -1
    )
    want = reference_sample2d_numpy(
        texf, fx / 32, fy / 24, filter_linear=True, wrap_mode="clamp_to_edge"
    )
    # the pass output is stored to an RGBA8 framebuffer like GL; the
    # matmul two-hot form (w0*a + w1*b) vs the oracle's lerp form can
    # flip rounding at exact quantization boundaries -> 1 LSB tolerance
    want = np.round(np.clip(want, 0, 1) * 255.0) / 255.0
    np.testing.assert_allclose(out, want[..., :3], atol=1.0 / 255.0 + 1e-6)


@pytest.mark.parametrize("wrap", WRAP_MODES)
@pytest.mark.parametrize("linear", [False, True])
def test_gather_exact_on_violent_warps(wrap, linear):
    """Warped grids take the plain XLA gather on every backend; it must
    be exact for arbitrary warps and every wrap mode, including a
    vertical warp that varies violently along x."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    tex = rng.random((24, 33, 4)).astype(np.float32)
    ho, wo = 37, 61
    yy, xx = np.meshgrid(
        np.linspace(0, 1, ho), np.linspace(0, 1, wo), indexing="ij"
    )
    u = (xx + 0.35 * np.sin(yy * 9) - 0.2).astype(np.float32)
    v = (yy * 1.6 - 0.3 + 0.45 * np.cos(xx * 7)).astype(np.float32)
    # Traced coordinates, as a shader's warp math produces them.
    got = np.asarray(
        jax.jit(
            lambda t, uu, vv: sample2d(
                t, uu, vv, filter_linear=linear, wrap_mode=wrap
            )
        )(jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v))
    )
    want = reference_sample2d_numpy(tex, u, v, filter_linear=linear, wrap_mode=wrap)
    np.testing.assert_allclose(got, want, atol=3e-6, err_msg=f"{wrap} lin={linear}")


@pytest.mark.parametrize("wrap", WRAP_MODES)
@pytest.mark.parametrize("linear", [False, True])
def test_block_periodic_axis_matches_matrix(wrap, linear, monkeypatch):
    """Rational-ratio (b > 1) axis resamples can lower to the
    block-periodic elementwise form (RCTPU_BLOCK_RESAMPLE=1; default off
    on chip measurement (xbr-lv2's 21 NEAREST taps to 1080p each paid a
    dense [1080,240]+[1920,320] matmul — ~125 GFLOP/frame of
    multiply-by-zero). NEAREST selection must be bit-identical to the
    one-hot matmul; LINEAR may differ by 1 ulp (mul+add vs the einsum's
    fused accumulate)."""
    monkeypatch.setenv("RCTPU_BLOCK_RESAMPLE", "1")
    import jax.numpy as jnp

    from retrocapture_tpu.ops.sampling import (
        _axis_block_plan,
        _axis_block_take,
        _axis_matrix,
    )

    rng = np.random.default_rng(7)
    for n_src, n_out in [(240, 1080), (320, 1920), (240, 560), (7, 33)]:
        for off_t in (-2.0, 0.0, 1.0, 2.5):
            tex = rng.random((n_src, 13, 4)).astype(np.float32)
            coord = (
                (np.arange(n_out, dtype=np.float64) + 0.5) / n_out
            ).astype(np.float32) + np.float32(off_t / n_src)
            plan = _axis_block_plan(coord, n_src, linear, wrap)
            assert plan is not None, (n_src, n_out, wrap, linear, off_t)
            got = np.asarray(_axis_block_take(jnp.asarray(tex), plan, 0, wrap))
            a = _axis_matrix(coord, n_src, linear, wrap)
            want = np.einsum("ms,swc->mwc", a, tex).astype(np.float32)
            if linear:
                np.testing.assert_allclose(
                    got, want, atol=1.2e-7, err_msg=f"{wrap} {n_src}->{n_out}"
                )
            else:
                assert np.array_equal(got, want), (n_src, n_out, wrap, off_t)


def test_block_periodic_axis1_and_ragged_tail(monkeypatch):
    """x-axis block take, plus an output length that is not a multiple of
    the phase count (ragged tail padding must slice back exactly)."""
    monkeypatch.setenv("RCTPU_BLOCK_RESAMPLE", "1")
    import jax.numpy as jnp

    from retrocapture_tpu.ops.sampling import (
        _axis_block_plan,
        _axis_block_take,
        _axis_matrix,
    )

    rng = np.random.default_rng(3)
    tex = rng.random((9, 320, 4)).astype(np.float32)
    for n_out in (1915, 1920, 1921):
        coord = ((np.arange(n_out, dtype=np.float64) + 0.5) / n_out).astype(
            np.float32
        ) - np.float32(1.0 / 320)
        plan = _axis_block_plan(coord, 320, False, "clamp_to_edge")
        assert plan is not None, n_out
        got = np.asarray(
            _axis_block_take(jnp.asarray(tex), plan, 1, "clamp_to_edge")
        )
        a = _axis_matrix(coord, 320, False, "clamp_to_edge")
        want = np.einsum("ms,hsc->hmc", a, tex).astype(np.float32)
        assert np.array_equal(got, want), n_out


def test_requant_u8_identity_on_quantized_grid():
    """quantized_u8=True must be a bit-identity for NEAREST separable
    samples of RGBA8-grid textures on the f32 backend (sampling.py
    _requant_u8): same einsum lowering, values snapped through uint8."""
    import jax.numpy as jnp

    from retrocapture_tpu.ops.sampling import sample2d

    rng = np.random.default_rng(7)
    k = rng.integers(0, 256, (24, 32, 4)).astype(np.float32)
    tex = jnp.asarray(k * np.float32(1.0 / 255.0))  # the engine's u8 grid
    yy, xx = np.meshgrid(
        ((np.arange(54) + 0.5) / 54).astype(np.float32),
        ((np.arange(70) + 0.5) / 70).astype(np.float32),
        indexing="ij",
    )
    for wrap in WRAP_MODES:
        a = np.asarray(
            sample2d(tex, xx, yy, filter_linear=False, wrap_mode=wrap)
        )
        b = np.asarray(
            sample2d(
                tex, xx, yy, filter_linear=False, wrap_mode=wrap,
                quantized_u8=True,
            )
        )
        assert np.array_equal(a, b), wrap
