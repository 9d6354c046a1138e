"""The engine's large-constant pool (frontend.values.ConstPool +
Engine._pool_wrap_impl).

Windowed-resampler chains fold per-tap weight/select fields into
genuinely-2D [oh, ow] concrete grids; embedded as HLO literals they
dominated program size (460 of 470 MB of StableHLO for the nnedi3
chains), and with it compile time and compile memory. The pool
discovers them with a throwaway eval_shape trace and threads them as jit
arguments.

These tests pin: (1) the pool ENGAGES on a jinc2-style chain (a gate
regression would silently re-inflate every program), and (2) outputs
with the pool on and off agree within 1 RGBA8 step on jinc2 (XLA fuses
FMA differently around constant vs parameter operands) and bitwise on
nnedi3."""

import numpy as np
import pytest

JINC2 = (
    "/root/reference/shaders/shaders_glsl/nnedi3/shaders/jinc2-cshift-rgb.glsl"
)


@pytest.fixture
def mini_preset(tmp_path):
    p = tmp_path / "mini.glslp"
    p.write_text(
        f"shaders = 1\nshader0 = {JINC2}\nfilter_linear0 = false\n"
    )
    return p


def _run(preset, frame):
    from retrocapture_tpu.runtime.engine import Engine

    e = Engine(viewport=(512, 384))
    assert e.load_preset(str(preset)), e.last_error
    return np.asarray(e.apply(frame))


def test_pool_engages_and_matches_literal_path(mini_preset, monkeypatch):
    import retrocapture_tpu.frontend.values as V

    rng = np.random.default_rng(3)
    frame = (rng.random((96, 128, 3)) * 255).astype(np.uint8)

    fetched = []
    orig = V.ConstPool.fetch

    def spy(self, x):
        fetched.append((self.mode, x.shape))
        return orig(self, x)

    monkeypatch.setattr(V.ConstPool, "fetch", spy)
    out_pool = _run(mini_preset, frame)
    assert any(m == "collect" for m, _ in fetched), "pool never engaged"
    assert any(m == "replay" for m, _ in fetched), "pooled jit never replayed"
    # every pooled grid is genuinely 2D and large
    assert all(len(s) >= 2 and int(np.prod(s)) >= V._POOL_MIN_SIZE
               for _, s in fetched)

    # literal path: threshold no grid can reach
    monkeypatch.setattr(V, "_POOL_MIN_SIZE", 1 << 60)
    fetched.clear()
    out_lit = _run(mini_preset, frame)
    assert not fetched
    # XLA fuses FMA differently around constant vs parameter operands,
    # so the two paths may differ by last-ulp products that flip
    # knife-edge u8 quantizes — the same class as the blit
    # certification (tests/test_blit.py). Identical values
    # except <= 1 RGBA8 step at a sparse set of pixels.
    d = np.abs(out_pool - out_lit)
    assert d.max() <= 1.5 / 255.0, f"max |d| = {d.max()}"
    frac = float((d > 0).mean())
    assert frac < 5e-3, f"{frac:.2e} of values differ"
