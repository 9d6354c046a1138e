"""The xbr-lv2 hand kernel (graph/kernels._xbr_lv2_kernel) vs the
generic GLSL evaluator, end-to-end through the Engine on CPU.

The kernel factors the tap + edge-detection section to an
[out_h, src_w] grid (exact per-offset y one-hot gathers reproduce the
f32 boundary flips of the affine sampler) and hands off to full width
through one channel-major one-hot matmul; agreement with the evaluator
must stay within one RGBA8 quantization level on every geometry,
including non-integer y ratios (4.5x) where f32 flips occur."""

import os

import numpy as np
import pytest


GEOMETRIES = [
    (48, 64, 256, 144),   # integer ratios, no flips
    (60, 80, 480, 270),   # y ratio 4.5: f32 boundary flips
    (48, 64, 384, 216),   # y ratio 4.5 at another size
    (30, 40, 240, 135),
]

PRESET = "/root/reference/shaders/shaders_glsl/xbr/xbr-lv2.glslp"


def _run(viewport, frame, kernels):
    from retrocapture_tpu.runtime.engine import Engine

    old = os.environ.get("RCTPU_KERNELS")
    os.environ["RCTPU_KERNELS"] = kernels
    try:
        e = Engine(viewport=viewport)
        assert e.load_preset(PRESET), e.last_error
        return np.asarray(e.apply(frame))
    finally:
        if old is None:
            os.environ.pop("RCTPU_KERNELS", None)
        else:
            os.environ["RCTPU_KERNELS"] = old


@pytest.mark.parametrize("h,w,vw,vh", GEOMETRIES)
def test_xbr_kernel_matches_evaluator(h, w, vw, vh):
    rng = np.random.default_rng(7)
    frame = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    out_k = _run((vw, vh), frame, "on")
    out_e = _run((vw, vh), frame, "off")
    assert out_k.shape == out_e.shape == (vh, vw, 3)
    err = np.abs(out_k - out_e).max()
    # one RGBA8 quantization level: boundary rounding only
    assert err <= 1.5 / 255.0, err


def _run_tail(viewport, frame, tail):
    old = os.environ.get("RCTPU_XBR")
    os.environ["RCTPU_XBR"] = tail
    try:
        return _run(viewport, frame, "on")
    finally:
        if old is None:
            os.environ.pop("RCTPU_XBR", None)
        else:
            os.environ["RCTPU_XBR"] = old


@pytest.mark.parametrize(
    "h,w,vw,vh",
    [
        (48, 64, 384, 288),   # x ratio 6, y ratio 6 (the bench shape class)
        (60, 80, 480, 270),   # x ratio 6, y ratio 4.5 (f32 row flips)
        (40, 64, 128, 120),   # x ratio 2, y ratio 3
    ],
)
def test_xbr_phase_tail_matches_dense(h, w, vw, vh):
    """The phase-factored tail (RCTPU_XBR=phase) must be bit-identical
    to the dense one-hot-matmul tail it replaces: the integer-ratio x
    upsample is an exact column replication, so factoring the blend to
    [oh, w, r] changes memory layout only (the batch-64 HBM cliff fix),
    not a single per-pixel value."""
    rng = np.random.default_rng(11)
    frame = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    out_p = _run_tail((vw, vh), frame, "phase")
    out_d = _run_tail((vw, vh), frame, "dense")
    assert out_p.shape == out_d.shape == (vh, vw, 3)
    assert np.array_equal(out_p, out_d), (
        f"max |d| = {np.abs(out_p - out_d).max()}"
    )
    # and the shared gate vs the evaluator still holds
    out_e = _run((vw, vh), frame, "off")
    assert np.abs(out_p - out_e).max() <= 1.5 / 255.0


def test_xbr_phase_tail_rejects_non_integer_ratio():
    """Non-integer x ratios must take the dense tail even when phase is
    requested (the gate is structural, not env-driven)."""
    rng = np.random.default_rng(13)
    frame = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    # 64 -> 250 is not an integer ratio.
    out_p = _run_tail((250, 144), frame, "phase")
    out_d = _run_tail((250, 144), frame, "dense")
    assert np.array_equal(out_p, out_d)


def test_xbr_kernel_small_details_branch():
    """small_details=1 uses the weighted_distance/Y-luma variant whose
    step() comparisons sit on exact ties for random input — f32
    summation-order differences between the kernel and the evaluator
    legitimately flip sparse edge decisions (real GL flips its own set:
    both implementations measure ~20 dB vs llvmpipe on noise, and are
    bit-exact on structured frames). Assert agreement at PSNR level."""
    rng = np.random.default_rng(9)
    frame = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    from retrocapture_tpu.runtime.engine import Engine

    outs = []
    for kernels in ("on", "off"):
        os.environ["RCTPU_KERNELS"] = kernels
        try:
            e = Engine(viewport=(256, 144))
            assert e.load_preset(PRESET)
            e.set_parameter("small_details", 1.0)
            outs.append(np.asarray(e.apply(frame)))
        finally:
            os.environ.pop("RCTPU_KERNELS", None)
    mse = float(((outs[0] - outs[1]) ** 2).mean())
    psnr = 10.0 * np.log10(1.0 / mse) if mse else float("inf")
    assert psnr >= 40.0, psnr
