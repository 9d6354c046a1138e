"""Counted-loop rolling into ``lax.fori_loop``.

The reference's GL compiler executes shader loops rolled in hardware;
the evaluator unrolls them at trace time, which explodes XLA compile
time for the procedural raymarchers (256-step marches nested with
50-step shadow loops — ShaderEngine.cpp:850-1475 runs these in real
time, so compile cost is the only thing standing between the corpus'
procedural family and the device). Loops of >= ROLL_MIN_TRIPS iterations
roll into one fori_loop after a short eager probe; these tests pin the
rolled path's exactness against the eager unroll on every loop-carried
construct the corpus uses (traced breaks, continues, out-params, global
writes, arrays, texture taps, float induction)."""

import os
import tempfile

import numpy as np
import pytest

import retrocapture_tpu.frontend.interp as interp_mod
from retrocapture_tpu.runtime.engine import Engine


def _run_frag(body: str, decls: str = "") -> np.ndarray:
    src = f"""
#if defined(VERTEX)
attribute vec4 VertexCoord; attribute vec4 TexCoord; varying vec4 TEX0;
void main() {{ gl_Position = VertexCoord; TEX0 = TexCoord; }}
#elif defined(FRAGMENT)
uniform sampler2D Texture; varying vec4 TEX0;
{decls}
void main() {{
{body}
}}
#endif
"""
    frame = (np.arange(8 * 8 * 3) % 251).astype(np.uint8).reshape(8, 8, 3)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "t.glsl")
        open(p, "w").write(src)
        pp = os.path.join(td, "t.glslp")
        open(pp, "w").write(f"shaders = 1\nshader0 = {p}\n")
        e = Engine(viewport=(8, 8))
        assert e.load_preset(pp), e.last_error
        out = np.asarray(e.apply(frame))
        assert e.shader_active, e.last_error
    return out


CASES = {
    # raymarch shape: traced break + scalar accumulators (iq-canyon's
    # intersect(), softshadow())
    "break_accum": (
        """
    vec3 c = texture2D(Texture, TEX0.xy).rgb;
    float t = 0.1;
    float acc = 0.0;
    for (int i = 0; i < 100; i++) {
        float h = 0.015 * (c.r + 0.3) * (1.0 + 0.01*float(i));
        acc += h;
        t += h;
        if (t > 1.0) break;
    }
    gl_FragColor = vec4(fract(t), fract(acc), 0.5, 1.0);
""",
        "",
    ),
    # continue at rolled-loop level + concrete inner loop unrolled
    # inside the rolled body
    "continue_nested": (
        """
    vec3 c = texture2D(Texture, TEX0.xy).rgb;
    float s = 0.0;
    for (int i = 0; i < 64; i++) {
        if (fract(float(i) * 0.37 + c.g) < 0.2) continue;
        float inner = 0.0;
        for (int j = 0; j < 3; j++) inner += c.b * 0.01 + float(j)*0.001;
        s += inner;
    }
    gl_FragColor = vec4(fract(s), 0.25, 0.5, 1.0);
""",
        "",
    ),
    # out-param copy-back + global mutation from a called function:
    # the write-set analysis must carry both 'o's root and 'gacc'
    "fn_global": (
        """
    vec3 c = texture2D(Texture, TEX0.xy).rgb;
    float s = 0.0;
    for (int i = 0; i < 80; i++) {
        float o;
        bump(c.r * 0.01, o);
        s += o;
    }
    gl_FragColor = vec4(fract(s), fract(gacc), 0.0, 1.0);
""",
        """
float gacc = 0.0;
void bump(float x, out float y) { y = x * 2.0; gacc += x; }
""",
    ),
    # vector and array loop-carried state
    "vec_array": (
        """
    vec3 c = texture2D(Texture, TEX0.xy).rgb;
    vec3 p = c;
    float w[3];
    w[0] = 0.1; w[1] = 0.2; w[2] = 0.3;
    for (int i = 0; i < 90; i++) {
        p = p * 0.99 + vec3(0.001, 0.002, 0.003);
        w[0] += p.x * 0.001;
    }
    gl_FragColor = vec4(fract(p), 1.0) * 0.5 + vec4(w[0], 0.0, 0.0, 0.5);
""",
        "",
    ),
    # texture sampling with loop-varying (traced) coordinates inside
    # the rolled body — the gather path under fori_loop
    "tex_in_loop": (
        """
    vec2 uv = TEX0.xy;
    vec3 s = vec3(0.0);
    float t = 0.0;
    for (int i = 0; i < 50; i++) {
        s += texture2D(Texture, fract(uv + vec2(t, t*0.5))).rgb * 0.01;
        t += 0.013;
    }
    gl_FragColor = vec4(s, 1.0);
""",
        "",
    ),
    # float induction variable: trip count must match exact f32
    # accumulation, and f participates in body math as the carry
    "float_induction": (
        """
    vec3 c = texture2D(Texture, TEX0.xy).rgb;
    float s = 0.0;
    for (float f = 0.0; f < 60.0; f += 1.0) {
        s += c.r * 0.001 + f * 0.0001;
    }
    gl_FragColor = vec4(fract(s), 0.0, 0.0, 1.0);
""",
        "",
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rolled_matches_eager(case):
    body, decls = CASES[case]
    saved = interp_mod.ROLL_MIN_TRIPS
    try:
        interp_mod.ROLL_MIN_TRIPS = 40
        rolled = _run_frag(body, decls)
        interp_mod.ROLL_MIN_TRIPS = 10**9
        eager = _run_frag(body, decls)
    finally:
        interp_mod.ROLL_MIN_TRIPS = saved
    np.testing.assert_array_equal(rolled, eager)


def test_roll_actually_engages():
    """The rolled path must be taken, not silently aborted to eager:
    count fori_loop invocations while tracing a 100-trip loop."""
    import jax

    calls = []
    orig = jax.lax.fori_loop

    def spy(lo, hi, f, init):
        calls.append(int(hi) - int(lo))
        return orig(lo, hi, f, init)

    jax.lax.fori_loop = spy
    try:
        _run_frag(*CASES["break_accum"])
    finally:
        jax.lax.fori_loop = orig
    # 100 trips = short eager probe + one rolled remainder
    assert calls and max(calls) >= 90, calls


def test_loop_beyond_unroll_cap_rolls():
    """Trip counts past MAX_UNROLL (512) used to degrade the preset to
    passthrough; rolled execution lifts the cap."""
    out = _run_frag(
        """
    vec3 c = texture2D(Texture, TEX0.xy).rgb;
    float s = 0.0;
    for (int i = 0; i < 1000; i++) {
        s += 0.001 * c.r;
    }
    gl_FragColor = vec4(fract(s), 0.0, 0.0, 1.0);
"""
    )
    assert out.std() > 0  # actually rendered, not passthrough


def test_concrete_break_during_probe_short_circuits():
    """A loop whose condition-independent break fires in the first
    probe iterations must finish early and exactly (no roll)."""
    out_a = _run_frag(
        """
    float s = 0.0;
    for (int i = 0; i < 100; i++) {
        s += 0.01;
        if (i == 0) break;
    }
    gl_FragColor = vec4(s, 0.0, 0.0, 1.0);
"""
    )
    np.testing.assert_allclose(out_a[..., 0], 0.01, atol=1 / 255.0)
