"""chip_smoke.py's phases at a tiny size on the CPU.

On the card the script runs each phase at 1920x1080 from 320x240, batch
64, against a reference on the CPU device. Here both sides are the CPU
device, so the comparison must be exact; what these tests check is the
control flow, the frame packing and the bars. ``main()`` itself insists
on a GPU and must refuse the CPU."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

HW = (24, 32)
VIEWPORT = (96, 54)


@pytest.fixture(scope="module")
def cpu():
    import jax

    return jax.devices("cpu")[0]


@pytest.mark.parametrize("chain", cs.CHAINS, ids=[c[0] for c in cs.CHAINS])
def test_chain_phases_tiny(chain, cpu):
    name, preset, fmt, bar = chain
    res = cs.run_chain(
        name, preset, fmt, bar, hw=HW, viewport=VIEWPORT, batch=4, n_ref=2,
        n_timed=2, device=cpu, ref_device=cpu,
    )
    assert res["max_abs_diff"] == 0 and res["psnr_db"] == float("inf")
    assert res["spatial_std"] >= cs.MIN_SPATIAL_STD
    assert res["mean_abs_diff_vs_passthrough"] >= cs.MIN_DIFF_FROM_PASSTHROUGH
    assert res["compiles_in_window"] == 0
    assert res["fps"] > 0 and res["compile_s"] > 0


@pytest.mark.parametrize("fmt", ["nv12", "yuyv", "rgb"])
def test_make_frames_decode_to_the_picture(fmt):
    """Packed frames decode (through the engine's own converter) to the
    seeded RGB picture within chroma-subsampling error."""
    import jax.numpy as jnp

    from retrocapture_tpu import Engine

    n, (h, w) = 3, HW
    frames = cs.make_frames(fmt, n, h, w)
    shapes = {"nv12": (n, h * 3 // 2, w), "yuyv": (n, h, w * 2), "rgb": (n, h, w, 3)}
    assert frames.dtype == np.uint8 and frames.shape == shapes[fmt]
    eng = Engine()
    eng.set_input_format(fmt)
    rgb = np.asarray(eng._convert_packed(jnp.asarray(frames)))
    if fmt == "rgb":
        rgb = rgb / 255.0
    want = cs._rgb_frames(n, h, w, cs.SEED) / 255.0
    # Luma is exact to rounding; chroma is averaged over 2 or 4 pixels.
    luma = lambda x: x @ np.array([0.299, 0.587, 0.114])  # noqa: E731
    assert np.abs(luma(rgb) - luma(want)).max() < 0.05
    assert np.abs(rgb - want).mean() < 0.15


def test_check_active_rejects_passthrough(cpu):
    eng = cs.new_engine("feedback-ghost.glslp", "rgb", VIEWPORT)
    out = (np.random.default_rng(0).random((2, 54, 96, 3)) * 255).astype(np.uint8)
    assert cs.check_active(eng, out, 255 - out)["spatial_std"] > 20
    with pytest.raises(RuntimeError, match="passthrough"):
        cs.check_active(eng, out, out)
    eng.shader_active = False
    with pytest.raises(RuntimeError, match="degraded"):
        cs.check_active(eng, out, 255 - out)


def test_onehot_precision_check_tiny():
    res = cs.check_onehot_exact(24, 32, VIEWPORT)
    assert res == {"onehot_requant_exact": True, "onehot_x255_exact": True}


def test_time_blit_tiny():
    assert cs.time_blit(2, 24, 32, VIEWPORT, 2) > 0


def test_main_refuses_cpu(capsys):
    assert cs.main([]) != 0
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "needs a GPU" in captured.err and "'cpu'" in captured.err
