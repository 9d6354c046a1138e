"""The nnedi3 matmul kernel family vs the generic evaluator.

nnedi3 embeds its neural net as ~nns*66 inline intBitsToFloat literals;
the kernel parses them once into [32, nns] matrices and runs the pass
as 32 shifted tap planes -> one matmul contraction -> fused mix ->
interleave (graph/kernels._nnedi3_kernel). Reference semantics:
shaders_glsl/nnedi3/shaders/nnedi3-nns16-win8x4-pass{1,2}-*.glsl
nnedi3(): even output rows (pass1) / cols (pass2) pass the source
through; odd ones are predicted from an 8x4 window.

The evaluator computes the same math with per-sample GLSL op order; the
matmul reassociates the 32-term dots, so agreement is at PSNR level
(exp amplifies ulps), asserted >= 60 dB — far above the 50 dB bar and
catastrophically failed by any tap/weight misindexing."""

import os

import numpy as np
import pytest

SHADERS = "/root/reference/shaders/shaders_glsl/nnedi3/shaders"


def _mini_preset(tmp_path, shader, scale_x, scale_y):
    p = tmp_path / "mini.glslp"
    p.write_text(
        "shaders = 1\n"
        f"shader0 = {SHADERS}/{shader}\n"
        "filter_linear0 = false\n"
        "scale_type0 = source\n"
        f"scale_x0 = {scale_x}\n"
        f"scale_y0 = {scale_y}\n"
    )
    return p


def _run(preset, viewport, frame, kernels):
    from retrocapture_tpu.runtime.engine import Engine

    old = os.environ.get("RCTPU_KERNELS")
    os.environ["RCTPU_KERNELS"] = kernels
    try:
        e = Engine(viewport=viewport)
        assert e.load_preset(str(preset)), e.last_error
        return np.asarray(e.apply(frame))
    finally:
        if old is None:
            os.environ.pop("RCTPU_KERNELS", None)
        else:
            os.environ["RCTPU_KERNELS"] = old


def _psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


@pytest.mark.parametrize(
    "shader,sx,sy,vw,vh",
    [
        ("nnedi3-nns16-win8x4-pass1-luma.glsl", 1.0, 2.0, 32, 48),
        ("nnedi3-nns16-win8x4-pass1-rgb.glsl", 1.0, 2.0, 32, 48),
        ("nnedi3-nns16-win8x4-pass2-rgb.glsl", 2.0, 1.0, 64, 24),
    ],
)
def test_nnedi3_kernel_matches_evaluator(tmp_path, shader, sx, sy, vw, vh):
    rng = np.random.default_rng(5)
    frame = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
    preset = _mini_preset(tmp_path, shader, sx, sy)
    out_k = _run(preset, (vw, vh), frame, "on")
    out_e = _run(preset, (vw, vh), frame, "off")
    assert out_k.shape == out_e.shape == (vh, vw, 3)
    # The passthrough rows/cols must be bit-identical (no NN math).
    if sy == 2.0:
        assert np.array_equal(out_k[0::2], out_e[0::2])
    else:
        assert np.array_equal(out_k[:, 0::2], out_e[:, 0::2])
    p = _psnr(out_k, out_e)
    assert p >= 60.0, f"kernel vs evaluator {p:.1f} dB"


def test_nnedi3_weight_parse():
    from retrocapture_tpu.graph.kernels import _nnedi3_weights

    for nns in (16, 32, 64):
        packs = _nnedi3_weights(
            f"{SHADERS}/nnedi3-nns{nns}-win8x4-pass1-rgb.glsl"
        )
        assert packs is not None, nns
        W1, W2, B1, B2 = packs
        assert W1.shape == W2.shape == (32, nns)
        assert B1.shape == B2.shape == (nns,)
        # Weights are smallish reals, never NaN/huge (intBitsToFloat of
        # garbage would explode) — a transposition bug shows up here.
        for a in (W1, W2, B1, B2):
            assert np.isfinite(a).all() and np.abs(a).max() < 1e4
