"""Phase-factored pass evaluation: the array-program answer to GL texel
caching for scaling shaders.

A scaling pass samples its input with NEAREST taps whose texel index is
constant across each run of output pixels that map to the same source
texel (xbr-lv2.glsl's 24 neighbour taps, ntsc-pass2's 65-tap FIR under
the viewport-height stretch, every hqx/scalefx/sabr-family shader). A GL
GPU re-fetches per output pixel and relies on the texture cache
(ShaderEngine::renderMultipassPass dispatch, ShaderEngine.cpp:850-1475);
here re-evaluating tap-derived math at output resolution materializes
dozens of full-resolution planes through HBM — the round-1 xbr chain
moved ~1.6 GB/frame for a 320x240 source.

Factored evaluation reshapes the output grid [OH, OW] into
[ry, rx, my, mx]: intra-run phase x axis runs, phases LEADING so the
minor (tiled) dimensions stay large — phases-minor layouts put rx~6 in
the minor dimension and ran every phase-mixing op at a few percent
occupancy. Texture taps whose index maps are
constant within runs become [1, 1, my, mx] source-resolution planes;
coordinate/phase math rides the phase axes as [ry, 1, my, 1] /
[1, rx, 1, mx] broadcasts. NumPy broadcasting keeps every elementwise op
at the smallest resolution that carries information, and XLA fuses the
broadcasts — the laziness costs nothing and requires no evaluator
changes. A final concrete row/column select maps the padded factored
grid back to [OH, OW] exactly (runs are measured from the same float32
index math the samplers use, so non-integer ratios like 1080/240 = 4.5
are handled by ry = 5 with per-run clamping).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Factorization", "plan_factorization", "FactoredBailout"]


class FactoredBailout(Exception):
    """A construct the factored path cannot lower (warped tap,
    derivative of traced data, …) — the caller re-runs the pass on the
    plain [OH, OW] grid."""


def _take_axis(arr, idx: np.ndarray, axis: int):
    """``arr`` indexed along ``axis`` by a concrete integer vector,
    lowered gather-free: phase-interleaved strided slices following the
    index progression's rational pattern (plus a concrete 0/1-mask blend
    for the sparse off-pattern positions), with edge padding supplying
    out-of-pattern read room. Falls back to ``jnp.take`` only when no
    small pattern exists (never for run/phase index maps)."""
    from retrocapture_tpu.ops.sampling import _phase_sliced_take, _rational_pattern

    idx = np.asarray(idx, np.int64)
    m = idx.shape[0]
    n = arr.shape[axis]
    pat = _rational_pattern(idx, max_den=24) if m >= 2 else None
    if pat is None and m >= 8:
        # Clamped-affine rescue: tap maps are typically
        # clip(affine, 0, n-1) — an identity progression plus a constant
        # tap offset that clamps at the texture edges, which breaks the
        # global fit. Fit the interior, extrapolate, and when the full
        # map is exactly the clip of the extrapolation, edge-pad the
        # array (the clamp IS edge padding) and slice with the pure
        # pattern.
        q0, q1 = m // 4, 3 * m // 4
        ipat = _rational_pattern(idx[q0:q1], max_den=24)
        if ipat is not None and not ipat[3].any():
            a, b, c = ipat[0], ipat[1], ipat[2] - ipat[0] * q0
            j = np.arange(m, dtype=np.int64)
            ext = (a * j + c) // b
            if np.array_equal(idx, np.clip(ext, 0, n - 1)):
                pat = (a, b, c, np.zeros(m, np.int64))
    if pat is None:
        return jnp.take(arr, jnp.asarray(idx), axis=axis)
    a, b, c, delta = pat
    has_delta = bool(delta.any())
    lo = min(int(idx.min()), c // b)
    mq = (m + b - 1) // b
    cmax = c + (b if has_delta else 0)
    max_read = max((a * r + cmax) // b + a * (mq - 1) for r in range(b))
    pad_lo = max(0, -lo)
    pad_hi = max(0, int(idx.max()) - (n - 1), max_read - (n - 1))
    if pad_lo or pad_hi:
        # Quantize pad widths to 128 (both sides) so every tap of a
        # multi-tap pass pads to the SAME shape and XLA CSEs one padded
        # tensor: the ntsc FIR's 65 taps each padded by their own 1..35
        # texels — 65 distinct ~315 MB edge-pads, ~40 GB of HBM traffic
        # per batch (measured 2.0 ms/frame; 10x the rest of the pass).
        q = 128
        both = ((max(pad_lo, pad_hi) + q - 1) // q) * q
        pad_lo = pad_hi = both
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (pad_lo, pad_hi)
        arr = jnp.pad(arr, widths, mode="edge")
    t0 = _phase_sliced_take(arr, (a, b, c + b * pad_lo), m, axis)
    if not has_delta:
        return t0
    t1 = _phase_sliced_take(arr, (a, b, c + b + b * pad_lo), m, axis)
    shape = [1] * arr.ndim
    shape[axis] = m
    # where-select, not 0/1-weight arithmetic: float-framebuffer data
    # carries NaNs and 0*NaN would bleed them across rows.
    mk = jnp.asarray(delta == 1).reshape(shape)
    return jnp.where(mk, t1, t0)


def _axis_runs(n_out: int, n_src: int, other: int, axis: str):
    """Runs of output pixels sharing a source texel for the identity
    TexCoord map, measured with the SAME float32 coordinate math the
    evaluator's plane-exact varyings produce (engine._plane_setup_f32 +
    _plane_component): the idealized (X + 0.5)/n_out form differs from
    the rasterizer planes by ulps, and a floor flip at a run boundary
    made every tap of the ntsc FIR fail run-constancy — 65 taps
    materialized at full factored volume (an HBM OOM at batch 32)."""
    from retrocapture_tpu.runtime.engine import _plane_setup_f32

    ow, oh = (n_out, other) if axis == "x" else (other, n_out)
    if axis == "x":
        a0, dadx, _ = _plane_setup_f32(ow, oh, 1.0, 1.0, 0.0)
        slope = dadx
    else:
        a0, _, dady = _plane_setup_f32(ow, oh, 0.0, 1.0, 1.0)
        slope = dady
    u = (
        np.float64(slope) * np.arange(n_out, dtype=np.float64) + np.float64(a0)
    ).astype(np.float32)
    idx = np.floor(u * np.float32(n_src)).astype(np.int64)
    change = np.flatnonzero(np.diff(idx)) + 1
    starts = np.concatenate([[0], change])
    lens = np.diff(np.concatenate([starts, [n_out]]))
    return starts.astype(np.int64), lens.astype(np.int64)


class Factorization:
    """Static description of one pass's factored grid."""

    __slots__ = (
        "oh", "ow", "my", "ry", "mx", "rx",
        "ystarts", "ylens", "xstarts", "xlens",
        "yidx", "xidx", "rowsel", "colsel",
    )

    def __init__(self, oh, ow, ystarts, ylens, xstarts, xlens):
        self.oh, self.ow = oh, ow
        self.ystarts, self.ylens = ystarts, ylens
        self.xstarts, self.xlens = xstarts, xlens
        self.my, self.ry = len(ystarts), int(ylens.max())
        self.mx, self.rx = len(xstarts), int(xlens.max())
        # True output indices per (run, phase); phases beyond a run's
        # length clamp to its last pixel (those slots are never selected
        # back, the clamp only keeps the evaluated coordinates valid).
        self.yidx = np.minimum(
            ystarts[:, None] + np.arange(self.ry)[None, :],
            (ystarts + ylens - 1)[:, None],
        ).astype(np.int64)
        self.xidx = np.minimum(
            xstarts[:, None] + np.arange(self.rx)[None, :],
            (xstarts + xlens - 1)[:, None],
        ).astype(np.int64)
        # Inverse: output row Y lives at factored slot (run, Y - start).
        yrun = np.repeat(np.arange(self.my), ylens)
        self.rowsel = (yrun * self.ry + (np.arange(oh) - ystarts[yrun])).astype(
            np.int64
        )
        xrun = np.repeat(np.arange(self.mx), xlens)
        self.colsel = (xrun * self.rx + (np.arange(ow) - xstarts[xrun])).astype(
            np.int64
        )

    # -- run-constancy checks for tap index maps ------------------------
    def x_run_values(self, idx_full: np.ndarray):
        """Per-run value of a full [OW] index map if it is constant
        within every x-run, else None."""
        lo = np.minimum.reduceat(idx_full, self.xstarts)
        hi = np.maximum.reduceat(idx_full, self.xstarts)
        return lo if np.array_equal(lo, hi) else None

    def y_run_values(self, idx_full: np.ndarray):
        lo = np.minimum.reduceat(idx_full, self.ystarts)
        hi = np.maximum.reduceat(idx_full, self.ystarts)
        return lo if np.array_equal(lo, hi) else None

    # -- grid seeds ------------------------------------------------------
    def seed_arrays(self):
        """(xg, yg) float32 true-pixel-index seeds shaped [1,rx,1,mx] and
        [ry,1,my,1]. Barriered: embedded constant grids make XLA
        constant-fold every broadcasted coordinate expression at compile
        time — single-threaded and O(pixels) per op, the round-1 155 s
        compile pathology (see _axis_matrix_device)."""
        xg = jax.lax.optimization_barrier(
            jnp.asarray(self.xidx.T.copy().astype(np.float32))
        ).reshape(1, self.rx, 1, self.mx)
        yg = jax.lax.optimization_barrier(
            jnp.asarray(self.yidx.T.copy().astype(np.float32))
        ).reshape(self.ry, 1, self.my, 1)
        return xg, yg

    @property
    def batch_shape(self):
        return (self.ry, self.rx, self.my, self.mx)

    # -- factored gathers ------------------------------------------------
    def take_full(self, tex, iyw: np.ndarray, ixw: np.ndarray):
        """Materialize a tap at full factored resolution from wrapped
        per-output index maps ([OH], [OW] np arrays): [ry,rx,my,mx,C].

        Decomposed PER PHASE: the flat [ry*my] composed map restarts its
        progression at every phase boundary, so no single rational
        pattern fits it and _take_axis degraded to full jnp.take gathers
        (measured: 16.4 GB of gather temporaries for the ntsc chain at
        batch 32 — an HBM OOM). Each phase's map iyw[starts + r] is a
        clean (clamped-)affine progression over [my] that slices."""
        rows = jnp.stack(
            [_take_axis(tex, iyw[self.yidx[:, r]], 0) for r in range(self.ry)],
            axis=0,
        )  # [ry, my, W, C]
        return jnp.stack(
            [_take_axis(rows, ixw[self.xidx[:, s]], 2) for s in range(self.rx)],
            axis=1,
        )  # [ry, rx, my, mx, C]

    def take_runs(self, tex, iy_runs: np.ndarray, ix_runs: np.ndarray):
        """Source-resolution tap from per-run wrapped indices:
        [1,1,my,mx,C]."""
        rows = _take_axis(tex, iy_runs, 0)
        out = _take_axis(rows, ix_runs, 1)
        c = tex.shape[-1]
        return out.reshape(1, 1, self.my, self.mx, c)

    # -- output flattening ----------------------------------------------
    def flatten(self, data):
        """Broadcastable factored data with a trailing channel dim →
        [OH, OW, C]. Separable: transpose the factored grid to
        (run-major, phase-minor) per axis and take rowsel/colsel along
        each axis as phase-interleaved strided slices (pure reshapes for
        uniform integer ratios) — jnp.take gathers here dominated
        factored chains where this was first measured (ntsc pass1 moved
        157 MB/batch through two gathers)."""
        c = data.shape[-1] if data.ndim else 1
        data = jnp.broadcast_to(data, (self.ry, self.rx, self.my, self.mx, c))
        # [ry, rx, my, mx, C] -> [(my ry), (mx rx), C]
        r = jnp.transpose(data, (2, 0, 3, 1, 4)).reshape(
            self.my * self.ry, self.mx * self.rx, c
        )
        out = _take_axis(r, self.rowsel, 0)
        return _take_axis(out, self.colsel, 1)


def factored_affine_tap(fac: Factorization, sampler, aff, oh: int, ow: int):
    """Lower one affine separable texture tap on the factored grid.

    NEAREST taps whose float32 texel-index maps are constant within the
    factorization's runs (integer-source-px offsets of the identity map —
    the xbr/hqx/ntsc tap families) gather at source resolution and ride
    the grid as [my,1,mx,1,C] broadcasts. Anything else (LUTs with alien
    cell structure, LINEAR taps) materializes at full factored resolution
    with exactly the same float32 index/weight math as
    ops/sampling._axis_matrix, so results match the plain path
    bit-for-bit."""
    from retrocapture_tpu.ops.sampling import WRAP_MODES, _wrap_index_np

    tex = jnp.asarray(sampler.tex)
    h, w = tex.shape[0], tex.shape[1]
    wrap = sampler.wrap_mode if sampler.wrap_mode in WRAP_MODES else "clamp_to_edge"
    u_row = (
        np.float64(aff[0][0]) * np.arange(ow, dtype=np.float64)
        + np.float64(aff[0][2])
    ).astype(np.float32)
    v_col = (
        np.float64(aff[1][1]) * np.arange(oh, dtype=np.float64)
        + np.float64(aff[1][2])
    ).astype(np.float32)

    def axis_nearest(coord, n):
        idx = np.floor(coord * np.float32(n)).astype(np.int64)
        return _wrap_index_np(idx, n, wrap)

    if not sampler.filter_linear:
        ix, vx = axis_nearest(u_row, w)
        iy, vy = axis_nearest(v_col, h)
        ixr = fac.x_run_values(ix)
        iyr = fac.y_run_values(iy)
        if ixr is not None and iyr is not None:
            out = fac.take_runs(tex, iyr, ixr)
            if vx is not None or vy is not None:  # border: zero invalid taps
                vxr = fac.x_run_values(vx.astype(np.int64))
                vyr = fac.y_run_values(vy.astype(np.int64))
                if vxr is None or vyr is None:
                    return _apply_border(
                        fac.take_full(tex, iy, ix), fac, vy, vx
                    )
                valid = (vyr[:, None] & vxr[None, :]).astype(np.float32)
                out = out * jnp.asarray(valid).reshape(1, 1, fac.my, fac.mx, 1)
            return out
        out = fac.take_full(tex, iy, ix)
        return _apply_border(out, fac, vy, vx) if (vx is not None or vy is not None) else out

    # LINEAR: two taps per axis with float32 lerp weights, matching
    # _axis_matrix's x = coord*n - 0.5 convention.
    def axis_linear(coord, n):
        x = coord * np.float32(n) - np.float32(0.5)
        x0 = np.floor(x).astype(np.int64)
        f = (x - x0).astype(np.float32)
        i0, v0 = _wrap_index_np(x0, n, wrap)
        i1, v1 = _wrap_index_np(x0 + 1, n, wrap)
        w0, w1 = np.float32(1.0) - f, f
        if v0 is not None:
            w0 = w0 * v0
        if v1 is not None:
            w1 = w1 * v1
        return (i0, w0), (i1, w1)

    xt = axis_linear(u_row, w)
    yt = axis_linear(v_col, h)

    # Run-constant fast path: all four corner index maps constant within
    # the factorization runs → four source-resolution planes combined
    # with concrete per-phase weights (no full-resolution gathers).
    xr = [fac.x_run_values(i) for i, _ in xt]
    yr = [fac.y_run_values(i) for i, _ in yt]
    if all(r is not None for r in xr) and all(r is not None for r in yr):
        out = None
        for (iyl, wy), iyrun in zip(yt, yr):
            wyf = jnp.asarray(wy[fac.yidx.T.reshape(-1)]).reshape(
                fac.ry, 1, fac.my, 1, 1
            )
            for (ixl, wx), ixrun in zip(xt, xr):
                wxf = jnp.asarray(wx[fac.xidx.T.reshape(-1)]).reshape(
                    1, fac.rx, 1, fac.mx, 1
                )
                term = fac.take_runs(tex, iyrun, ixrun) * (wyf * wxf)
                out = term if out is None else out + term
        return out

    out = None
    for iyl, wy in yt:
        row_acc = None
        wyf = jnp.asarray(wy[fac.yidx.T.reshape(-1)]).reshape(
            fac.ry, 1, fac.my, 1, 1
        )
        for ixl, wx in xt:
            term = fac.take_full(tex, iyl, ixl)
            wxf = jnp.asarray(wx[fac.xidx.T.reshape(-1)]).reshape(
                1, fac.rx, 1, fac.mx, 1
            )
            term = term * wxf
            row_acc = term if row_acc is None else row_acc + term
        row_acc = row_acc * wyf
        out = row_acc if out is None else out + row_acc
    return out


def _apply_border(out, fac: Factorization, vy, vx):
    """Zero border-invalid taps on a full-factored plane."""
    valid = np.ones((), bool)
    if vy is not None:
        valid = valid & vy[fac.yidx.T.reshape(-1)].reshape(fac.ry, 1, fac.my, 1)
    if vx is not None:
        vv = vx[fac.xidx.T.reshape(-1)].reshape(1, fac.rx, 1, fac.mx)
        valid = valid & vv
    return out * jnp.asarray(np.broadcast_to(valid, fac.batch_shape).astype(np.float32))[..., None]


def plan_factorization(
    oh: int, ow: int, in_h: int, in_w: int, *, max_overhead: float = 1.4
):
    """A Factorization for the pass geometry, or None when factoring
    cannot pay: no axis actually repeats, or the padded factored grid
    would exceed ``max_overhead`` times the true pixel count."""
    import os

    if os.environ.get("RCTPU_FACTORED") == "off":
        return None
    if oh < 2 or ow < 2 or in_h < 1 or in_w < 1:
        return None
    ys, yl = _axis_runs(oh, max(in_h, 1), ow, "y")
    xs, xl = _axis_runs(ow, max(in_w, 1), oh, "x")
    f = Factorization(oh, ow, ys, yl, xs, xl)
    if f.ry < 2 and f.rx < 2:
        return None
    # Only low phase-volume factorizations pay on this backend: tap-
    # dominated passes with one scaling axis (the ntsc FIR under its
    # viewport-height stretch: 274 -> 561 fps) win, while fragments with
    # large phase-mixing sections (xbr's fp-driven edge blending) lose —
    # their full-phase-volume ops don't fuse into few kernels and the
    # chain runs several times slower than the plain grid.
    # RCTPU_FACTORED=all skips the volume gate for A/B runs.
    if f.ry * f.rx > 8 and os.environ.get("RCTPU_FACTORED") != "all":
        return None
    padded = f.my * f.ry * f.mx * f.rx
    if padded > max_overhead * oh * ow:
        return None
    return f
