"""Hand-kernel engagement gates (graph/kernels.py).

The kernel registry returns None on any gate miss and the engine falls
back to the generic evaluator SILENTLY — correct output, ~2x the frame
time. A varyings-metadata change once flipped the xbr TEX0 plane from
vec4 to its declared vec2 and the old uniform ``len(affine) != 4`` gate
disabled the kernel for a full bench cycle.
These tests pin the gates: at the exact bench geometries the kernels
MUST engage; at geometries they cannot serve they must bail to the
evaluator rather than crash."""

import numpy as np
import pytest

import retrocapture_tpu.graph.kernels as K

XBR_PRESET = "/root/reference/shaders/shaders_glsl/xbr/xbr-lv2.glslp"


def _probe_engagement(preset, viewport, src_hw):
    """Trace one chain on CPU and report whether each registered hand
    kernel produced the pass output."""
    from retrocapture_tpu.runtime.engine import Engine

    calls = {}
    saved_registry = dict(K._REGISTRY)

    def wrap(name, fn):
        def probe(ctx, sh):
            out = fn(ctx, sh)
            calls[name] = out is not None
            return out

        return probe

    try:
        for name, fn in saved_registry.items():
            K._REGISTRY[name] = wrap(name, fn)
        e = Engine(viewport=viewport)
        assert e.load_preset(preset), e.last_error
        h, w = src_hw
        f = (np.random.default_rng(0).random((1, h, w, 3)) * 255).astype(np.uint8)
        out = np.asarray(e.apply(f))
        assert np.isfinite(out).all()
        return calls
    finally:
        K._REGISTRY.clear()
        K._REGISTRY.update(saved_registry)


@pytest.mark.slow
def test_xbr_kernel_engages_at_bench_geometry():
    calls = _probe_engagement(XBR_PRESET, (1920, 1080), (240, 320))
    assert calls.get("xbr-lv2.glsl") is True, (
        "xbr-lv2 hand kernel bailed to the evaluator at the BASELINE "
        f"bench geometry (gates: {calls})"
    )


@pytest.mark.slow
def test_xbr_kernel_engages_at_noninteger_y_ratio():
    # 240->1080 y ratio 4.5 with integer x ratio: the kernel's x-exactness
    # gate must hold and the per-offset y one-hot maps absorb the flips.
    calls = _probe_engagement(XBR_PRESET, (384, 216), (48, 64))
    assert calls.get("xbr-lv2.glsl") is True


@pytest.mark.slow
def test_xbr_kernel_bails_on_noninteger_x_ratio():
    # 320 -> 1000 x: tap indices are not uniform source-column shifts
    # everywhere; the kernel must bail (None) and the evaluator serve it.
    # A gate that wrongly ENGAGES here would produce wrong tap indices,
    # so assert the bail itself, not just that the gate was consulted
    # (advisor round-2 finding).
    calls = _probe_engagement(XBR_PRESET, (1000, 750), (240, 320))
    assert calls.get("xbr-lv2.glsl") is False, (
        "xbr-lv2 hand kernel must bail (return None) at a non-integer "
        f"x ratio; gates: {calls}"
    )
