"""ntsc 2-phase hand kernel (graph/kernels.py) vs the evaluator.

The pass1 encode runs with precomputed [2, W] chroma-phase constants;
pass2 (the 65-tap FIR) runs on the evaluator either way. The chain is
compared with the kernel library on and off (the GL-parity-certified
reference — ntsc-320px family is PSNR=inf vs the real-GL oracle with
the pass1 kernel active).

Residual differences on random f32 inputs come from the evaluator's own
tap-matmul summation path; hence tolerance-based assertions here (the
bit-level claim lives in the GL parity sweep, which compares final u8).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest

SHADERS = Path("/root/reference/shaders/shaders_glsl")


def _mk_preset(tmp_path, body: str) -> str:
    p = tmp_path / "t.glslp"
    p.write_text(body)
    return str(p)


def _run(preset, frame, viewport, mode, frames=2):
    from retrocapture_tpu import Engine

    os.environ["RCTPU_KERNELS"] = mode
    try:
        e = Engine(viewport=viewport)
        assert e.load_preset(preset), e.last_error
        return [np.asarray(e.apply(frame)) for _ in range(frames)]
    finally:
        os.environ.pop("RCTPU_KERNELS", None)


def test_phase_rows_are_lp_trig_of_stepwise_phase():
    from retrocapture_tpu.frontend.builtins import _lp_trig
    from retrocapture_tpu.graph.kernels import _NTSC_CMF2, _NTSC_PI, _ntsc_phase_rows

    cosr, sinr = _ntsc_phase_rows(64)
    x = np.arange(64, dtype=np.float32) + np.float32(0.5)
    t = (x * _NTSC_CMF2).astype(np.float32)
    for fcm in range(2):
        for ypar in range(2):
            s = np.float32(np.float32(ypar) + np.float32(0.5)) + np.float32(
                np.float32(fcm)
            )
            mp = (np.float32(_NTSC_PI * s) + t).astype(np.float32)
            assert np.array_equal(cosr[fcm, ypar], _lp_trig(np, mp, True))
            assert np.array_equal(sinr[fcm, ypar], _lp_trig(np, mp, False))


@pytest.mark.parametrize("viewport", [(128, 48), (128, 96)])
def test_ntsc_chain_kernel_vs_evaluator(tmp_path, viewport):
    """Full 2-pass chain at reduced geometry; (128, 96) exercises the
    last-pass NEAREST row expansion (y upgrades to viewport)."""
    preset = _mk_preset(
        tmp_path,
        f"""shaders = 2
shader0 = {SHADERS}/ntsc/shaders/ntsc-pass1-composite-2phase.glsl
shader1 = {SHADERS}/ntsc/shaders/ntsc-pass2-2phase-gamma.glsl
filter_linear0 = false
filter_linear1 = false
scale_type_x0 = absolute
scale_type_y0 = source
scale_x0 = 256
scale_y0 = 1.0
frame_count_mod0 = 2
float_framebuffer0 = true
scale_type1 = source
scale_x1 = 0.5
scale_y1 = 1.0
""",
    )
    rng = np.random.default_rng(0)
    frame = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    ev = _run(preset, frame, viewport, "off")
    kn = _run(preset, frame, viewport, "on")
    for a, b in zip(ev, kn):
        assert a.shape == b.shape
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        # Residual = summation-order differences, quantized at the
        # final u8-grid store: a few 1/255 steps.
        assert d.max() <= 4.5 / 255.0, d.max()
        assert (d > 0).mean() < 0.2
