"""Hand-written kernel-library entries for the benchmark shader families
(SURVEY.md §7 lowering tier (a)).

The generic evaluator lowers any GLSL; these entries replace specific
hot fragments with a plain-jnp formulation whose saving is in the
algorithm (source-resolution tap sections, one contraction instead of
tap-by-tap lowering), while keeping the evaluator as the semantic
reference (tests compare the two).

Selection is by shader basename via ``find_kernel``; entries must check
static feasibility themselves and return None to fall back. Every entry
runs on every backend. Set ``RCTPU_KERNELS=off`` to disable the library
(tests use it to run the evaluator on the same chain).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["find_kernel"]


# ---------------------------------------------------------------------------
# xbr-lv2 (shaders_glsl/xbr/shaders/xbr-lv2.glsl): the whole tap + edge-
# detection section is phase-independent — every NEAREST tap index is an
# integer offset of the base source texel — so it runs at SOURCE
# resolution; only the fp-ramp blend is full-res, its ramps are 1D outer
# sums, and the handoff is ONE stacked 19-channel NEAREST upsample
# (a one-hot matmul) instead of 21 per-tap full-res resamples (the
# generic-path cost).

_XBR_RGBW = np.array([14.352, 28.176, 5.472], np.float32)
# vec4 line constants (xbr-lv2.glsl:182-191)
_XBR_AO = np.array([1.0, -1.0, -1.0, 1.0], np.float32)
_XBR_BO = np.array([1.0, 1.0, -1.0, -1.0], np.float32)
_XBR_CO = np.array([1.5, 0.5, -0.5, 0.5], np.float32)
_XBR_AX = np.array([1.0, -1.0, -1.0, 1.0], np.float32)
_XBR_BX = np.array([0.5, 2.0, -0.5, -2.0], np.float32)
_XBR_CX = np.array([1.0, 1.0, -0.5, 0.0], np.float32)
_XBR_AY = np.array([1.0, -1.0, -1.0, 1.0], np.float32)
_XBR_BY = np.array([2.0, 0.5, -2.0, -0.5], np.float32)
_XBR_CY = np.array([2.0, 0.0, -1.0, 0.5], np.float32)
_XBR_CI = np.array([0.25, 0.25, 0.25, 0.25], np.float32)
_XBR_SCALE = np.float32(3.0)  # #define XBR_SCALE 3.0 (pragma commented out)

# (name, dx texels, dy texels) for the 21 neighbourhood taps.
_XBR_TAPS = [
    ("A1", -1, -2), ("B1", 0, -2), ("C1", 1, -2),
    ("A", -1, -1), ("B", 0, -1), ("C", 1, -1),
    ("D", -1, 0), ("E", 0, 0), ("F", 1, 0),
    ("G", -1, 1), ("H", 0, 1), ("I", 1, 1),
    ("G5", -1, 2), ("H5", 0, 2), ("I5", 1, 2),
    ("A0", -2, -1), ("D0", -2, 0), ("G0", -2, 1),
    ("C4", 2, -1), ("F4", 2, 0), ("I4", 2, 1),
]


def _xbr_axis_maps(ctx, ow: int, oh: int, w: int, h: int):
    """Concrete replication of the evaluator's coordinate math from the
    pass's rasterizer-exact varying planes (engine._plane_varyings): the
    xbr tap coordinates are the t1..t7 varyings (TEX1..TEX7 after the
    cg2glsl defines), each plane-fit from its own float32 corner values,
    and the sampler floors ``f32(f64(d)*j + f64(a0)) * f32(n)`` exactly
    like sample2d_affine. fp mirrors the fragment's f32 data math
    ``fract(texCoord * TextureSize)`` on the TEX0 plane vectors.
    Returns (bx, fpx, tx, by, fpy, ty) or None when the planes aren't
    available (traced params, renamed varyings)."""
    from retrocapture_tpu.runtime.engine import _plane_varyings

    cp = ctx.program.passes[ctx.i]
    try:
        planes, plane_cover = _plane_varyings(cp, ctx, ow, oh)
    except Exception:
        return None
    if plane_cover is not None:
        return None  # transformed quad: evaluator path handles coverage
    # TEX0 (texCoord) is a vec2 varying; t1..t7 are vec4s. Require per-name
    # component counts — the round-2 plane-exact varyings rework started
    # fitting TEX0 as its declared vec2 and the old uniform ``!= 4`` gate
    # silently disabled this kernel (xbr bench fell back to the evaluator).
    need = {"TEX0": 2, "TEX1": 4, "TEX2": 4, "TEX3": 4, "TEX4": 4,
            "TEX5": 4, "TEX6": 4, "TEX7": 4}
    for nm, ncomp in need.items():
        v = planes.get(nm)
        if v is None or v.affine is None or len(v.affine) < ncomp:
            return None

    def aff(nm, comp):
        return planes[nm].affine[comp]

    def col_idx(a, n, m):
        dadx, dady, a0 = a
        if dady != 0.0:
            return None
        row = (np.float64(dadx) * np.arange(m, dtype=np.float64) + np.float64(a0)).astype(np.float32)
        return np.floor(row * np.float32(n)).astype(np.int64)

    def row_idx(a, n, m):
        dadx, dady, a0 = a
        if dadx != 0.0:
            return None
        col = (np.float64(dady) * np.arange(m, dtype=np.float64) + np.float64(a0)).astype(np.float32)
        return np.floor(col * np.float32(n)).astype(np.int64)

    # x taps: A0/D0/G0 column = t6.x (-2dx), t1.x/.y/.z = -dx,0,+dx,
    # C4/F4/I4 column = t7.x (+2dx).
    tx = {
        -2: col_idx(aff("TEX6", 0), w, ow),
        -1: col_idx(aff("TEX1", 0), w, ow),
        0: col_idx(aff("TEX1", 1), w, ow),
        1: col_idx(aff("TEX1", 2), w, ow),
        2: col_idx(aff("TEX7", 0), w, ow),
    }
    ty = {
        -2: row_idx(aff("TEX1", 3), h, oh),
        -1: row_idx(aff("TEX2", 3), h, oh),
        0: row_idx(aff("TEX3", 3), h, oh),
        1: row_idx(aff("TEX4", 3), h, oh),
        2: row_idx(aff("TEX5", 3), h, oh),
    }
    if any(v is None for v in tx.values()) or any(v is None for v in ty.values()):
        return None

    def fp_of(a, n, m):
        dadx, dady, a0 = a
        d = dadx if dady == 0.0 else dady
        coord = (np.float64(d) * np.arange(m, dtype=np.float64) + np.float64(a0)).astype(np.float32)
        prod = coord * np.float32(n)
        return (prod - np.floor(prod)).astype(np.float32)

    ax, ay = aff("TEX0", 0), aff("TEX0", 1)
    if ax[1] != 0.0 or ay[0] != 0.0:
        return None
    fpx = fp_of(ax, w, ow)
    fpy = fp_of(ay, h, oh)
    return tx[0], fpx, tx, ty[0], fpy, ty


def _xbr_lv2_kernel(ctx, sh):
    cfg = ctx.program.preset.passes[ctx.i]
    if cfg.filter_linear or cfg.wrap_mode != "clamp_to_edge":
        return None
    params = ctx.params

    def p(name, default):
        v = params.get(name, np.float32(default))
        if not isinstance(v, (int, float, np.generic)):
            return None  # traced parameter: fall back to the evaluator
        return np.float32(v)

    eq_thr = p("XBR_EQ_THRESHOLD", 15.0)
    lv2_cf = p("XBR_LV2_COEFFICIENT", 2.0)
    small = p("small_details", 0.0)
    y_weight = p("XBR_Y_WEIGHT", 48.0)
    if None in (eq_thr, lv2_cf, small, y_weight):
        return None

    tex = ctx.input_binding.tex
    h, w = int(tex.shape[0]), int(tex.shape[1])
    ow, oh = ctx.out_size
    maps = _xbr_axis_maps(ctx, ow, oh, w, h)
    if maps is None:
        return None
    bx, fpx, tx, by, fpy, ty = maps
    # x-exactness gate: every x-tap's f32-floored index must equal
    # clamp(base + k) everywhere (true whenever ow/w is an integer ratio,
    # e.g. 320->1920), so x offsets factor to source-column shifts. The
    # y-axis needs no such property: each of the 5 y offsets gets its own
    # exact one-hot row gather below, so y f32 boundary flips (e.g.
    # 240->1080 flips ~20 rows per offset) are reproduced bit-for-bit.
    for k, arr in tx.items():
        if not np.array_equal(np.clip(arr, 0, w - 1), np.clip(bx + k, 0, w - 1)):
            return None

    # On the RGBA8 grid, colors ride as exact small integers (levels
    # x255 <= 255) and flag codes are <= 31, so every one-hot matmul is
    # exact at DEFAULT precision: TF32 and bf16 operands both hold 8-bit
    # integers exactly and the one-hot sum adds exact zeros. Off-grid
    # input (a packed-format convert, a float framebuffer) needs f32.
    prec = (
        jax.lax.Precision.DEFAULT
        if ctx.input_binding.quantized
        else jax.lax.Precision.HIGHEST
    )
    tex255 = tex[..., :3].astype(jnp.float32) * 255.0
    iw_h = jnp.arange(h, dtype=jnp.int32)[None, :]
    ytex = {}
    for k in (-2, -1, 0, 1, 2):
        idx = jax.lax.optimization_barrier(
            jnp.asarray(np.clip(ty[k], 0, h - 1).astype(np.int32))
        )
        My = (iw_h == idx[:, None]).astype(jnp.float32)  # [oh, h]
        ytex[k] = jnp.einsum(
            "Hs,swc->Hwc", My, tex255,
            preferred_element_type=jnp.float32, precision=prec,
        )  # [oh, w, 3] exact ints

    inv255 = np.float32(1.0 / 255.0)
    pads = {
        k: jnp.pad(v, ((0, 0), (2, 2), (0, 0)), mode="edge") for k, v in ytex.items()
    }

    def tap(dx, dy):  # [oh, w, 3] plane: exact y map, x source-shift
        return jax.lax.slice(
            pads[dy], (0, 2 + dx, 0), (oh, 2 + dx + w, 3)
        ) * inv255

    t = {name: tap(dx, dy) for name, dx, dy in _XBR_TAPS}
    rgbw = jnp.asarray(_XBR_RGBW)

    def lum(x):
        return x[..., 0] * rgbw[0] + x[..., 1] * rgbw[1] + x[..., 2] * rgbw[2]

    L = {name: lum(v) for name, v in t.items()}

    # "vec4"s ride as LISTS of four [oh, w] planes, never stacked, so no
    # 4-wide minor dimension reaches the fused loops. Per-pixel values
    # and op order are identical to the stacked form; only the memory
    # layout of the fused loops changes.
    def v4(*names):
        return [L[n] for n in names]

    b4 = v4("B", "D", "H", "F")
    c4 = v4("C", "A", "G", "I")
    d4 = v4("D", "H", "F", "B")
    e4 = [L["E"]] * 4
    f4_ = v4("F", "B", "D", "H")
    g4 = v4("G", "I", "C", "A")
    h4 = v4("H", "F", "B", "D")
    i4_ = v4("I", "C", "A", "G")
    if small < 0.5:
        i4 = v4("I4", "C1", "A0", "G5")
        i5 = v4("I5", "C4", "A1", "G0")
        h5 = v4("H5", "F4", "B1", "D0")
    else:
        # mul(mat4x3(A,B,C,D), y_weight*Y): rows are dot(tap, y_weight*Y)
        Y = jnp.asarray(np.array([0.2126, 0.7152, 0.0722], np.float32)) * jnp.float32(y_weight)

        def lumY(x):
            return x[..., 0] * Y[0] + x[..., 1] * Y[1] + x[..., 2] * Y[2]

        i4 = [lumY(t[n]) for n in ("I4", "C1", "A0", "G5")]
        i5 = [lumY(t[n]) for n in ("I5", "C4", "A1", "G0")]
        h5 = [lumY(t[n]) for n in ("H5", "F4", "B1", "D0")]
    f44 = [jnp.zeros_like(p) for p in i4]  # `vec4 f4` never assigned

    def df(a, b):
        return [jnp.abs(x - y) for x, y in zip(a, b)]

    def diff(a, b):
        return [(x != y).astype(jnp.float32) for x, y in zip(a, b)]

    def eq(a, b):
        return [
            (jnp.abs(x - y) <= eq_thr).astype(jnp.float32) for x, y in zip(a, b)
        ]

    def neq(a, b):
        return [np.float32(1.0) - x for x in eq(a, b)]

    def lmul(*ls):
        out = ls[0]
        for nxt in ls[1:]:
            out = [x * y for x, y in zip(out, nxt)]
        return out

    def ladd(*ls):
        out = ls[0]
        for nxt in ls[1:]:
            out = [x + y for x, y in zip(out, nxt)]
        return out

    def smul(s, a):
        return [np.float32(s) * x for x in a]

    irlv0 = lmul(diff(e4, f4_), diff(e4, h4))
    # CORNER_C (the compiled-in variant, xbr-lv2.glsl:41,307-309)
    irlv1 = lmul(
        irlv0,
        ladd(
            lmul(neq(f4_, b4), neq(f4_, c4)),
            lmul(neq(h4, d4), neq(h4, g4)),
            lmul(
                eq(e4, i4_),
                ladd(lmul(neq(f4_, f44), neq(f4_, i4)), lmul(neq(h4, h5), neq(h4, i5))),
            ),
            eq(e4, g4),
            eq(e4, c4),
        ),
    )
    irlv2l = lmul(diff(e4, g4), diff(d4, g4))
    irlv2u = lmul(diff(e4, c4), diff(b4, c4))

    if small < 0.5:
        wd1 = ladd(
            df(e4, c4), df(e4, g4), df(i4_, h5), df(i4_, f44),
            smul(4.0, df(h4, f4_)),
        )
        wd2 = ladd(
            df(h4, d4), df(h4, i5), df(f4_, i4), df(f4_, b4),
            smul(4.0, df(e4, i4_)),
        )
    else:
        wd1 = ladd(
            df(e4, c4), df(e4, g4), df(i4_, f44), df(i4_, h5),
            df(b4, d4), df(i4, i5), smul(2.0, df(h4, f4_)),
        )
        wd2 = ladd(
            df(h4, d4), df(h4, i5), df(f4_, b4), df(f4_, i4),
            df(g4, h5), df(c4, f44), smul(2.0, df(e4, i4_)),
        )

    edri = lmul([(y >= x).astype(jnp.float32) for x, y in zip(wd1, wd2)], irlv0)
    edr = [
        (y >= x + np.float32(0.1)).astype(jnp.float32)
        * (z >= np.float32(0.5)).astype(jnp.float32)
        for x, y, z in zip(wd1, wd2, irlv1)
    ]
    edr_l = lmul(
        [
            (x >= lv2_cf * y).astype(jnp.float32)
            for x, y in zip(df(h4, c4), df(f4_, g4))
        ],
        irlv2l,
        edr,
    )
    edr_u = lmul(
        [
            (x >= lv2_cf * y).astype(jnp.float32)
            for x, y in zip(df(f4_, g4), df(h4, c4))
        ],
        irlv2u,
        edr,
    )
    px = [
        (x >= y).astype(jnp.float32) for x, y in zip(df(e4, h4), df(e4, f4_))
    ]

    # Pack the five binary vec4 flags into 4 integer-code channels
    # (0..31, exact in f32) so the upsample moves 4 planes, not 20.
    code_planes = [
        edri[ci]
        + 2.0 * edr[ci]
        + 4.0 * edr_l[ci]
        + 8.0 * edr_u[ci]
        + 16.0 * px[ci]
        for ci in range(4)
    ]
    code = jnp.stack(code_planes, axis=-1)

    # Handoff to full width: stack the 19 per-[oh, w] planes
    # channel-major and contract the x axis with a one-hot column-select
    # matrix — einsum("chs,Ws->chW") lands directly in [19, oh, ow]
    # layout with NO full-res transpose, at the precision chosen above.
    def tap_raw(dx, dy):  # [oh, w, 3] plane, exact x255 integers
        return jax.lax.slice(pads[dy], (0, 2 + dx, 0), (oh, 2 + dx + w, 3))

    E255, H255, F255, B255, D255 = (
        ytex[0], ytex[1], tap_raw(1, 0), ytex[-1], tap_raw(-1, 0)
    )
    planes = [
        E255[..., 0], E255[..., 1], E255[..., 2],
        H255[..., 0], H255[..., 1], H255[..., 2],
        F255[..., 0], F255[..., 1], F255[..., 2],
        B255[..., 0], B255[..., 1], B255[..., 2],
        D255[..., 0], D255[..., 1], D255[..., 2],
        code[..., 0], code[..., 1], code[..., 2], code[..., 3],
    ]
    S = jnp.stack(planes, axis=0)  # [19, oh, w]

    def decode_flags(ucode):
        """Unpack the 5 binary vec4 flags from the 4 integer-code planes
        (any broadcastable layout)."""
        edri_f, edr_f, edrl_f, edru_f, px_f = [], [], [], [], []
        for ci in range(4):
            r = ucode[ci]
            edri_f.append(jnp.remainder(r, 2.0))
            r = jnp.floor(r * 0.5)
            edr_f.append(jnp.remainder(r, 2.0))
            r = jnp.floor(r * 0.5)
            edrl_f.append(jnp.remainder(r, 2.0))
            r = jnp.floor(r * 0.5)
            edru_f.append(jnp.remainder(r, 2.0))
            px_f.append(jnp.floor(r * 0.5))
        return edri_f, edr_f, edrl_f, edru_f, px_f

    def blend(E, Hc, Fc, Bc, Dc, flags, fpyj, fpxj):
        """The fp-ramp blend (fx45/fx30/fx60/fx45i + px mixes + final
        res1/res2 select), layout-agnostic: operands broadcast against
        the fpyj/fpxj grids, so the same op sequence runs at [oh, ow]
        (dense) or [oh, w, r] (phase-factored) with identical per-pixel
        values and order."""
        edri_f, edr_f, edrl_f, edru_f, px_f = flags
        delta = np.float32(1.0) / _XBR_SCALE
        delta_l = np.array([0.5, 1.0, 0.5, 1.0], np.float32) / _XBR_SCALE
        delta_u = np.array([1.0, 0.5, 1.0, 0.5], np.float32) / _XBR_SCALE
        d4v = np.full(4, delta, np.float32)

        def ramp(A, B, C, d, ci, extra=0.0):
            x = (
                A[ci] * fpyj + B[ci] * fpxj + np.float32(d[ci] - C[ci] - extra)
            ) * np.float32(1.0 / (2.0 * d[ci]))
            return jnp.clip(x, 0.0, 1.0)

        maximos = []
        for ci in range(4):
            m = jnp.maximum(
                jnp.maximum(
                    edrl_f[ci] * ramp(_XBR_AX, _XBR_BX, _XBR_CX, delta_l, ci),
                    edru_f[ci] * ramp(_XBR_AY, _XBR_BY, _XBR_CY, delta_u, ci),
                ),
                jnp.maximum(
                    edr_f[ci] * ramp(_XBR_AO, _XBR_BO, _XBR_CO, d4v, ci),
                    edri_f[ci]
                    * ramp(_XBR_AO, _XBR_BO, _XBR_CO, d4v, ci, extra=0.25),
                ),
            )
            maximos.append(m)

        def mixc(a, b, m):  # per-channel-plane mix
            return [ac + (bc - ac) * m for ac, bc in zip(a, b)]

        Tx = mixc(Hc, Fc, px_f[0])
        Tz = mixc(Bc, Dc, px_f[2])
        Ty = mixc(Fc, Bc, px_f[1])
        Tw = mixc(Dc, Hc, px_f[3])
        res1 = mixc(mixc(E, Tx, maximos[0]), Tz, maximos[2])
        res2 = mixc(mixc(E, Ty, maximos[1]), Tw, maximos[3])

        def c_df(c1, c2):
            return (
                jnp.abs(c1[0] - c2[0])
                + jnp.abs(c1[1] - c2[1])
                + jnp.abs(c1[2] - c2[2])
            )

        sel = (c_df(E, res2) >= c_df(E, res1)).astype(jnp.float32)
        return mixc(res1, res2, sel)

    inv = np.float32(1.0 / 255.0)
    bx_c = np.clip(bx, 0, w - 1)

    # Phase-replicated tail (RCTPU_XBR=phase, opt-in): when the x
    # upsample is an exact integer-ratio column replication
    # (bx == repeat(arange(w), r) — true for the 320->1920 bench
    # geometry), build every full-width operand as
    # jnp.repeat(plane, r, axis=1) instead of the dense one-hot matmul,
    # whose [19, oh, ow] f32 product is ~158 MB/frame at 1080p.
    # Bit-identical to the dense path (replication preserves every
    # operand value; the op sequence is shared in blend()), and memory
    # traffic scales with the [oh, w] front planes only. The dense tail
    # stays the default until the two are timed against each other on
    # the GPU.
    xbr_tail = os.environ.get("RCTPU_XBR", "dense")
    rr = ow // w if ow % w == 0 else 0
    phase_ok = (
        xbr_tail == "phase"
        and rr >= 1
        and bool(
            np.array_equal(bx_c, np.repeat(np.arange(w, dtype=bx_c.dtype), rr))
        )
    )
    if phase_ok:
        def up_rep(p2d):  # [oh, w] -> [oh, ow] exact column replication
            return jnp.repeat(p2d, rr, axis=1)

        E = [up_rep(E255[..., i]) * inv for i in range(3)]
        Hc = [up_rep(H255[..., i]) * inv for i in range(3)]
        Fc = [up_rep(F255[..., i]) * inv for i in range(3)]
        Bc = [up_rep(B255[..., i]) * inv for i in range(3)]
        Dc = [up_rep(D255[..., i]) * inv for i in range(3)]
        flags = decode_flags([up_rep(code_planes[ci]) for ci in range(4)])
        fpyj = jnp.asarray(fpy)[:, None]
        fpxj = jnp.asarray(fpx)[None, :]
        res = blend(E, Hc, Fc, Bc, Dc, flags, fpyj, fpxj)
        return jnp.stack(res + [jnp.ones((oh, ow), jnp.float32)], axis=-1)

    bxi = jax.lax.optimization_barrier(jnp.asarray(bx_c.astype(np.int32)))
    Ax = (jnp.arange(w, dtype=jnp.int32)[None, :] == bxi[:, None]).astype(
        jnp.float32
    )  # [ow, w]
    up = jnp.einsum(
        "chs,Ws->chW", S, Ax, preferred_element_type=jnp.float32, precision=prec
    )

    E = [up[i] * inv for i in range(3)]
    Hc = [up[3 + i] * inv for i in range(3)]
    Fc = [up[6 + i] * inv for i in range(3)]
    Bc = [up[9 + i] * inv for i in range(3)]
    Dc = [up[12 + i] * inv for i in range(3)]
    flags = decode_flags([up[15 + i] for i in range(4)])
    # fp ramps: separable 1D outer sums, clamped (fx45/fx30/fx60/fx45i).
    fpyj = jnp.asarray(fpy)[:, None]
    fpxj = jnp.asarray(fpx)[None, :]
    res = blend(E, Hc, Fc, Bc, Dc, flags, fpyj, fpxj)
    return jnp.stack(res + [jnp.ones((oh, ow), jnp.float32)], axis=-1)


# ---------------------------------------------------------------------------
# ntsc pass1 (composite/svideo, 2-phase): the modulate/cross-talk/
# demodulate encode (ntsc-pass1-composite-2phase.glsl, fragment main).
#
# Key structure exploited: with frame_count_mod0=2 (ntsc-320px.glslp)
# the shader sees FrameCount in {0, 1}, and the chroma-phase trig
#   i_mod = cos(PI*(mod(pix_no.y,2)+fc) + pix_no.x*CHROMA_MOD_FREQ)
# depends on the pixel only through (y&1, x) — so the i_mod/q_mod
# fields have exactly FOUR [W]-row variants (2 y-parities x 2 fc
# values), precomputed here as numpy constants with the SAME stepwise
# f32 op order and the same llvmpipe-bit-matched trig (_lp_trig) the
# evaluator uses. Under vmap with a traced per-frame FrameCount the
# whole trig field reduces to one dynamic row-pair select — nothing
# FrameCount-dependent is recomputed per frame (the profiled "pass0
# costs 4x its math" plumbing tax, PARITY.md r3).
#
# The 320->1280 absolute-scale x-upsample is NEAREST with an integer
# ratio (texel = x // r), i.e. jnp.repeat — no gathers, no tap matmuls.
# ---------------------------------------------------------------------------

# begin params block constants (f32 stepwise, evaluator order)
_NTSC_PI = np.float32(3.14159265)
_NTSC_CMF2 = np.float32(np.float32(4.0) * _NTSC_PI) / np.float32(15.0)

# rgb2yiq / mix_mat columns ([col][row] per GLSL column-major ctor).
_NTSC_YIQ_COLS = (
    (np.float32(0.2989), np.float32(0.5870), np.float32(0.1140)),
    (np.float32(0.5959), np.float32(-0.2744), np.float32(-0.3216)),
    (np.float32(0.2115), np.float32(-0.5229), np.float32(0.3114)),
)


def _ntsc_phase_rows(w_out: int):
    """[2(fc), 2(y&1), w_out] cos/sin chroma-phase constants, bit-matched
    to the evaluator: same f32 step order, same _lp_trig polynomials
    (numpy path = exact-FMA llvmpipe match)."""
    from retrocapture_tpu.frontend.builtins import _lp_trig

    x = np.arange(w_out, dtype=np.float32) + np.float32(0.5)  # pix_no.x
    t = (x * _NTSC_CMF2).astype(np.float32)
    cosr = np.empty((2, 2, w_out), np.float32)
    sinr = np.empty((2, 2, w_out), np.float32)
    for fcm in range(2):
        for ypar in range(2):
            s = np.float32(np.float32(ypar) + np.float32(0.5)) + np.float32(
                np.float32(fcm)
            )
            cp = np.float32(_NTSC_PI * s)
            mp = (cp + t).astype(np.float32)
            cosr[fcm, ypar] = _lp_trig(np, mp, True)
            sinr[fcm, ypar] = _lp_trig(np, mp, False)
    return cosr, sinr


def _ntsc_pass1_2phase_kernel(ctx, sh, *, svideo: bool):
    cfg = ctx.program.preset.passes[ctx.i]
    if cfg.filter_linear or cfg.wrap_mode != "clamp_to_edge" or cfg.mipmap_input:
        return None
    if cfg.frame_count_mod != 2:
        return None  # field enumeration relies on fc in {0, 1}
    ow, oh = ctx.out_size
    h, w = sh.in_h, sh.in_w
    # ow % w == 0 (with ow >= 1) already implies ow >= w, so no separate
    # minimum-ratio clause (r4 advisor: the old `ow // w < 1` was dead).
    if oh != h or ow % w != 0:
        return None
    r = ow // w
    tex = ctx.input_binding.tex
    if tex.shape[0] != h or tex.shape[1] != w:
        return None

    fc = ctx.frame_count
    cosr, sinr = _ntsc_phase_rows(ow)  # [2, 2, ow]
    from retrocapture_tpu.frontend.values import is_concrete

    if is_concrete(fc):
        fcm = int(np.asarray(fc)) % 2
        # Barrier: without it the row-pair constants + tile form a
        # pure-constant subgraph XLA folds to a full [h, ow] literal at
        # compile time (single-threaded; the _axis_matrix_device lesson).
        ci = jax.lax.optimization_barrier(jnp.asarray(cosr[fcm]))  # [2, ow]
        si = jax.lax.optimization_barrier(jnp.asarray(sinr[fcm]))
    else:
        fcm = (fc % 2).astype(jnp.int32)
        ci = jax.lax.dynamic_index_in_dim(
            jnp.asarray(cosr), fcm, axis=0, keepdims=False
        )
        si = jax.lax.dynamic_index_in_dim(
            jnp.asarray(sinr), fcm, axis=0, keepdims=False
        )
    # Row-parity tiling [h, ow] (h may be odd: tile then slice).
    reps = (h + 1) // 2
    i_mod = jnp.tile(ci, (reps, 1))[:h]
    q_mod = jnp.tile(si, (reps, 1))[:h]

    # v * mat einsums in the evaluator's exact form (builtins._mat_mul,
    # also at HIGHEST), keeping this kernel bit-identical to the
    # evaluator on the CPU, which is what the GL parity record certifies
    # (gl_parity sweep: ntsc-320px{,-svideo}{,-gauss-scanline} all PSNR
    # inf with the kernel active). GLSL mat math is f32: a TF32 dot on
    # the GPU would round the pixel operand to 11 significant bits.
    hi = jax.lax.Precision.HIGHEST
    up = jnp.repeat(tex[..., :3], r, axis=1)  # [h, ow, 3] NEAREST
    yiq_mat = np.array(_NTSC_YIQ_COLS, np.float32)  # [cols, rows]
    yiq = jnp.einsum("...r,cr->...c", up, yiq_mat, precision=hi)
    mod2 = jnp.stack([i_mod, q_mod], axis=-1)
    yiq = jnp.concatenate([yiq[..., :1], yiq[..., 1:] * mod2], axis=-1)
    if svideo:
        mix_cols = ((1.0, 0.0, 0.0), (0.0, 2.0, 0.0), (0.0, 0.0, 2.0))
    else:
        mix_cols = ((1.0, 1.0, 1.0), (1.0, 2.0, 0.0), (1.0, 0.0, 2.0))
    yiq = jnp.einsum(
        "...r,cr->...c", yiq, np.array(mix_cols, np.float32), precision=hi
    )
    yiq = jnp.concatenate([yiq[..., :1], yiq[..., 1:] * mod2], axis=-1)
    return jnp.concatenate([yiq, jnp.ones((h, ow, 1), jnp.float32)], axis=-1)


def _ntsc_pass1_composite_2phase(ctx, sh):
    """ntsc-pass1-composite-2phase.glsl (ntsc/ntsc-320px.glslp pass 0)."""
    return _ntsc_pass1_2phase_kernel(ctx, sh, svideo=False)


def _ntsc_pass1_svideo_2phase(ctx, sh):
    """ntsc-pass1-svideo-2phase.glsl (ntsc/ntsc-320px-svideo.glslp)."""
    return _ntsc_pass1_2phase_kernel(ctx, sh, svideo=True)


# ---------------------------------------------------------------------------
# nnedi3 (shaders_glsl/nnedi3/shaders/nnedi3-nns*-win8x4-pass{1,2}-*.glsl):
# neural edge-directed doubling. The shader embeds its net as ~nns*66
# inline intBitsToFloat literals and evaluates, per predicted pixel, an
# 8x4-window [32]-vector through 2*nns neuron dot products — i.e. a
# [32, 2*nns] matmul written out longhand. Lowered tap-by-tap this makes
# the triple-stage chain (nnedi3-nns64-2x-nns32-4x-nns16-8x) a program of
# about a gigabyte serialized and costs minutes of XLA CPU compile
# (corpus timeouts). Here the weights are parsed ONCE from the shader
# text into device arrays and the whole pass becomes: 32 shifted tap
# planes -> one matmul contraction ->
# fused softmax-style mix -> row/col interleave. pass2 is pass1
# transposed (x-doubling); -rgb runs 3 channels, -luma channel 0 only.
#
# Tap geometry (pass1, scale source 1x2, NEAREST, clamp_to_edge —
# nnedi3-nns16-win8x4-pass1-luma.glsl nnedi3()): output row 2r is the
# source row r passthrough; output row 2r+1 is predicted from source
# rows r-1..r+2 and columns x-3..x+4. The half-texel floors are exact
# in f32 (offsets 0.25/0.75 are dyadic), so taps are pure integer
# shifts with edge clamp.

_NNEDI3_W_RE = None


def _nnedi3_weights(shader_path: str):
    """Parse the per-neuron weight literals from the shader source.
    Returns (W1 [32, nns], B1 [nns], W2 [32, nns], B2 [nns]) float32,
    or None when the source does not match the expected structure.
    Weight order: flat q = s*4 + c over samples[s] components — the
    window position is (dy, dx) = (s//2 - 1, (s % 2)*4 + c - 3) for
    pass1, transposed for pass2 (handled by the tap builder)."""
    import re

    global _NNEDI3_W_RE
    if _NNEDI3_W_RE is None:
        _NNEDI3_W_RE = (
            re.compile(r"W\((\d),(-?\d+),(-?\d+),(-?\d+),(-?\d+)\)"),
            re.compile(r"WS\((-?\d+),(-?\d+)\)"),
            re.compile(r"sum1=(.*?);sum2=(.*?);WS\((-?\d+),(-?\d+)\);"),
        )
    w_re, _ws_re, line_re = _NNEDI3_W_RE
    try:
        src = Path(shader_path).read_text(encoding="utf-8", errors="replace")
    except OSError:
        return None
    neurons = line_re.findall(src)
    if not neurons:
        return None
    w1, w2, b1, b2 = [], [], [], []

    def vec32(expr):
        terms = w_re.findall(expr)
        if len(terms) != 8:
            return None
        v = np.zeros(32, np.int32)
        seen = set()
        for s, a, b, c, d in terms:
            s = int(s)
            if s in seen:
                return None
            seen.add(s)
            v[s * 4 : s * 4 + 4] = [int(a), int(b), int(c), int(d)]
        return v

    for e1, e2, bb1, bb2 in neurons:
        v1, v2 = vec32(e1), vec32(e2)
        if v1 is None or v2 is None:
            return None
        w1.append(v1)
        w2.append(v2)
        b1.append(int(bb1))
        b2.append(int(bb2))
    W1 = np.stack(w1, axis=1).view(np.float32)
    W2 = np.stack(w2, axis=1).view(np.float32)
    B1 = np.asarray(b1, np.int32).view(np.float32)
    B2 = np.asarray(b2, np.int32).view(np.float32)
    if not (np.isfinite(W1).all() and np.isfinite(W2).all()):
        return None
    return W1, W2, B1, B2


_NNEDI3_WCACHE: dict = {}


def _nnedi3_kernel(ctx, sh, *, axis: int, comps: int):
    """axis 0 = pass1 (y-doubling), 1 = pass2 (x-doubling); comps 3 for
    -rgb, 1 for -luma."""
    cfg = ctx.program.preset.passes[ctx.i]
    if cfg.filter_linear or cfg.wrap_mode != "clamp_to_edge" or cfg.mipmap_input:
        return None
    tex = ctx.input_binding.tex
    h, w = int(tex.shape[0]), int(tex.shape[1])
    ow, oh = ctx.out_size
    if axis == 0 and (ow != w or oh != 2 * h):
        return None
    if axis == 1 and (ow != 2 * w or oh != h):
        return None

    spath = ctx.program.preset.passes[ctx.i].shader_path
    key = str(spath)
    if key not in _NNEDI3_WCACHE:
        _NNEDI3_WCACHE[key] = _nnedi3_weights(key)
    packs = _NNEDI3_WCACHE[key]
    if packs is None:
        return None
    W1, W2, B1, B2 = packs
    nns = W1.shape[1]

    # 32 tap planes at source resolution. q = s*4 + cw; pass1 window
    # (dy, dx) = (s//2 - 1, (s%2)*4 + cw - 3); pass2 transposes.
    if axis == 0:
        pad = ((1, 2), (3, 4))
    else:
        pad = ((3, 4), (1, 2))
    src = tex[..., :comps].astype(jnp.float32)
    padded = jnp.pad(src, (pad[0], pad[1], (0, 0)), mode="edge")
    taps = []
    for s in range(8):
        for cw in range(4):
            du, dv = s // 2 - 1, (s % 2) * 4 + cw - 3  # (minor, major)
            dy, dx = (du, dv) if axis == 0 else (dv, du)
            oy, ox = dy + pad[0][0], dx + pad[1][0]
            taps.append(
                jax.lax.slice(padded, (oy, ox, 0), (oy + h, ox + w, comps))
            )
    S = jnp.stack(taps, axis=0)  # [32, h, w, comps]

    ssum = jnp.sum(S, axis=0)
    sumsq = jnp.sum(S * S, axis=0)
    mstd0 = ssum * np.float32(1.0 / 32.0)
    mstd1 = sumsq * np.float32(1.0 / 32.0) - mstd0 * mstd0
    ok = mstd1 >= np.float32(1.192092896e-7)
    mstd2 = jnp.where(ok, 1.0 / jnp.sqrt(mstd1), 0.0)
    mstd1 = mstd1 * mstd2

    # The neuron contraction at HIGHEST (f32): the weights are real
    # floats, not grid integers, and TF32 or bf16 operand rounding would
    # cost 3-4 decimal digits against the evaluator.
    d1 = jnp.einsum(
        "qhwc,qn->nhwc", S, jnp.asarray(W1),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    d2 = jnp.einsum(
        "qhwc,qn->nhwc", S, jnp.asarray(W2),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    e1 = jnp.exp(d1 * mstd2[None] + jnp.asarray(B1)[:, None, None, None])
    s2 = d2 * mstd2[None] + jnp.asarray(B2)[:, None, None, None]
    wsum = jnp.sum(e1, axis=0)
    vsum = jnp.sum(e1 * (s2 / (1.0 + jnp.abs(s2))), axis=0)
    pred = jnp.clip(mstd0 + np.float32(5.0) * vsum / wsum * mstd1, 0.0, 1.0)

    # Interleave passthrough/predicted along the doubled axis (even
    # positions are the source rows/cols — mod(p, 2) == 0 branch).
    if axis == 0:
        both = jnp.stack([src, pred], axis=1)  # [h, 2, w, comps]
        out = both.reshape(2 * h, w, comps)
    else:
        both = jnp.stack([src, pred], axis=2)  # [h, w, 2, comps]
        out = both.reshape(h, 2 * w, comps)
    if comps == 1:
        ones = jnp.ones((oh, ow, 1), jnp.float32)
        return jnp.concatenate([out, ones, ones, ones], axis=-1)
    return jnp.concatenate(
        [out, jnp.ones((oh, ow, 1), jnp.float32)], axis=-1
    )


def _make_nnedi3(axis: int, comps: int):
    def k(ctx, sh):
        return _nnedi3_kernel(ctx, sh, axis=axis, comps=comps)

    return k


_REGISTRY = {
    "xbr-lv2.glsl": _xbr_lv2_kernel,
    "ntsc-pass1-composite-2phase.glsl": _ntsc_pass1_composite_2phase,
    "ntsc-pass1-svideo-2phase.glsl": _ntsc_pass1_svideo_2phase,
}

for _nns in (16, 32, 64):
    for _pass, _ax in (("pass1", 0), ("pass2", 1)):
        for _kind, _nc in (("luma", 1), ("rgb", 3)):
            _REGISTRY[f"nnedi3-nns{_nns}-win8x4-{_pass}-{_kind}.glsl"] = (
                _make_nnedi3(_ax, _nc)
            )


def find_kernel(shader_path: str):
    """Hand kernel for a pass, or None (``RCTPU_KERNELS=off`` disables
    the whole library)."""
    if os.environ.get("RCTPU_KERNELS", "on") == "off":
        return None
    return _REGISTRY.get(Path(shader_path).name)
