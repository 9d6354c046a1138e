"""Smoke check of the shader-chain engine on one NVIDIA GPU.

    python chip_smoke.py

Drives the main path a user calls (``Engine.load_preset`` ->
``set_input_format`` -> ``apply(..., output="u8")``) over the two in-repo
chains at the reference's default operating point: 320x240 capture
frames to a 1920x1080 viewport, 64 frames per call (about one second of
60 fps capture).

  * feedback-ghost, NV12 input: fused NV12 convert, PassFeedback state
    through ``lax.scan``, the 6x/4.5x u8 viewport blit;
  * smoke-crt, YUYV input: the frame-history ring, a warped LINEAR
    multi-tap gather and a separable LINEAR upscale.

For each chain it checks that the shader is really active (the
reference smoke thresholds: spatial std >= 20, mean |shaded - passthrough|
>= 5.0), compares 4 frames against a fresh engine on the CPU device at
``highest`` matmul precision, and times the chain. It then confirms the
DEFAULT-precision one-hot matmuls stay exact, and times the viewport
blit alone. Frames are made here from a fixed seed.

Every number goes to stdout with the card's name and power limit. The
last line is one JSON object with the device JAX reports. Any failed
phase exits nonzero without that line; with no GPU the script exits
nonzero and names the platform it found.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PRESETS = REPO / "assets" / "presets"

SOURCE_HW = (240, 320)
VIEWPORT = (1920, 1080)  # (W, H)
BATCH = 64
REF_FRAMES = 4
TIMED_BATCHES = 10
SEED = 20260

# (name, preset file, input format, comparison bar)
CHAINS = [
    ("feedback-ghost", "feedback-ghost.glslp", "nv12", {"max_abs": 1}),
    ("smoke-crt", "smoke-crt.glslp", "yuyv", {"psnr_db": 50.0}),
]

# Reference smoke thresholds (BASELINE.md: tools/smoke-test.sh:168-299).
MIN_SPATIAL_STD = 20.0
MIN_DIFF_FROM_PASSTHROUGH = 5.0


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


# -- frames --------------------------------------------------------------


def _rgb_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """SMPTE bars with the moving marker, plus per-frame seeded noise."""
    from retrocapture_tpu.io.testpattern import TestPatternSource

    base = TestPatternSource(w, h).capture_batch(n).astype(np.int16)
    noise = np.random.default_rng(seed).integers(-64, 65, base.shape, np.int16)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _ycbcr(rgb: np.ndarray):
    """BT.601 limited-range Y, Cb, Cr planes (float) of uint8 RGB."""
    x = rgb.astype(np.float64) / 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 16.0 + 65.481 * r + 128.553 * g + 24.966 * b
    cb = 128.0 - 37.797 * r - 74.203 * g + 112.0 * b
    cr = 128.0 + 112.0 * r - 93.786 * g - 18.214 * b
    return y, cb, cr


def _u8(x) -> np.ndarray:
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def make_frames(fmt: str, n: int, h: int, w: int, seed: int = SEED) -> np.ndarray:
    """``n`` packed capture frames of an ``h`` x ``w`` picture:
    nv12 [n, h*3/2, w], yuyv [n, h, w*2] or rgb [n, h, w, 3], uint8."""
    rgb = _rgb_frames(n, h, w, seed)
    if fmt == "rgb":
        return rgb
    y, cb, cr = _ycbcr(rgb)
    if fmt == "nv12":
        # 2x2 chroma averages, interleaved U,V rows under the Y plane.
        cb2 = cb.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
        cr2 = cr.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
        uv = np.stack([cb2, cr2], axis=-1).reshape(n, h // 2, w)
        return np.concatenate([_u8(y), _u8(uv)], axis=1)
    if fmt == "yuyv":
        # Horizontal pairs share chroma: Y0 U Y1 V.
        yp = y.reshape(n, h, w // 2, 2)
        cb2 = cb.reshape(n, h, w // 2, 2).mean(axis=-1)
        cr2 = cr.reshape(n, h, w // 2, 2).mean(axis=-1)
        packed = np.stack([yp[..., 0], cb2, yp[..., 1], cr2], axis=-1)
        return _u8(packed.reshape(n, h, w * 2))
    raise ValueError(f"unknown input format {fmt!r}")


# -- phases --------------------------------------------------------------


def new_engine(preset: str | None, fmt: str, viewport):
    """A fresh Engine on the public surface; ``preset=None`` is the
    passthrough engine. Fails unless the preset loads."""
    from retrocapture_tpu import Engine

    eng = Engine(viewport=viewport)
    if preset is not None and not eng.load_preset(str(PRESETS / preset)):
        raise RuntimeError(f"load_preset({preset}) failed: {eng.last_error}")
    eng.set_input_format(fmt)
    return eng


def check_active(eng, out_u8: np.ndarray, passthrough_u8: np.ndarray) -> dict:
    """Phase 1: the shader ran (no passthrough degrade) and changed the
    picture by the reference smoke thresholds."""
    if not eng.shader_active:
        raise RuntimeError(f"shader degraded to passthrough: {eng.last_error}")
    x = out_u8.astype(np.float64)
    std = float(x.reshape(x.shape[0], -1, x.shape[-1]).std(axis=1).mean())
    mad = float(np.abs(x - passthrough_u8.astype(np.float64)).mean())
    if std < MIN_SPATIAL_STD:
        raise RuntimeError(f"spatial std {std:.2f} < {MIN_SPATIAL_STD}")
    if mad < MIN_DIFF_FROM_PASSTHROUGH:
        raise RuntimeError(
            f"mean |shaded - passthrough| {mad:.2f} < {MIN_DIFF_FROM_PASSTHROUGH}"
        )
    return {"spatial_std": std, "mean_abs_diff_vs_passthrough": mad}


def run_on(device, preset: str, fmt: str, frames: np.ndarray, viewport) -> np.ndarray:
    """A fresh engine on ``device`` applied once to ``frames`` (u8 out)."""
    import jax

    with jax.default_device(device):
        eng = new_engine(preset, fmt, viewport)
        out = eng.apply(jax.device_put(frames, device), output="u8")
        if not eng.shader_active:
            raise RuntimeError(f"shader degraded on {device}: {eng.last_error}")
        return np.asarray(out)


def compare_reference(
    preset: str, fmt: str, frames: np.ndarray, viewport, device, ref_device, bar: dict
) -> dict:
    """Phase 2: the same frames through a fresh engine on ``device`` and
    on ``ref_device`` at highest matmul precision; u8 outputs compared
    against ``bar`` (max |d| steps and/or PSNR dB)."""
    import jax

    got = run_on(device, preset, fmt, frames, viewport)
    with jax.default_matmul_precision("highest"):
        want = run_on(ref_device, preset, fmt, frames, viewport)
    if got.shape != want.shape:
        raise RuntimeError(f"shape {got.shape} != reference {want.shape}")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    mse = float((d.astype(np.float64) ** 2).mean())
    res = {
        "max_abs_diff": int(d.max()),
        "frac_diff": float((d > 0).mean()),
        "psnr_db": float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse)),
    }
    if "max_abs" in bar and res["max_abs_diff"] > bar["max_abs"]:
        raise RuntimeError(f"max |d| {res['max_abs_diff']} > {bar['max_abs']} u8 steps")
    if "psnr_db" in bar and res["psnr_db"] < bar["psnr_db"]:
        raise RuntimeError(f"PSNR {res['psnr_db']:.2f} dB < {bar['psnr_db']} dB")
    return res


class CompileCounter:
    """Counts backend compiles and persistent-cache loads while active."""

    _EVENTS = ("/jax/core/compile/backend_compile_duration",)

    def __init__(self):
        self.count = 0

    def _on_duration(self, event: str, _secs: float, **_kw) -> None:
        if event in self._EVENTS:
            self.count += 1

    def _on_event(self, event: str, **_kw) -> None:
        if event == "/jax/compilation_cache/cache_hits":
            self.count += 1

    def __enter__(self):
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._on_duration)
        jax.monitoring.register_event_listener(self._on_event)
        return self

    def __exit__(self, *exc):
        import jax

        jax.monitoring.unregister_event_duration_listener(self._on_duration)
        jax.monitoring.unregister_event_listener(self._on_event)
        return False


def time_chain(eng, batches: list, n_timed: int, device) -> dict:
    """Phase 3: compile + first call, one warm-up call, then ``n_timed``
    calls closed by block_until_ready. Returns the first call's output
    and the timings."""
    t0 = time.perf_counter()
    first = eng.apply(batches[0], output="u8").block_until_ready()
    compile_s = time.perf_counter() - t0
    eng.apply(batches[1 % len(batches)], output="u8").block_until_ready()
    n_frames = 0
    with CompileCounter() as cc:
        t0 = time.perf_counter()
        out = None
        for i in range(n_timed):
            b = batches[i % len(batches)]
            out = eng.apply(b, output="u8")
            n_frames += b.shape[0]
        out.block_until_ready()
        dt = time.perf_counter() - t0
    stats = device.memory_stats() or {}
    return {
        "first_out": np.asarray(first),
        "compile_s": compile_s,
        "fps": n_frames / dt,
        "step_ms": 1e3 * dt / n_timed,
        "compiles_in_window": cc.count,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }


def time_blit(batch: int, h: int, w: int, viewport, n_timed: int) -> float:
    """Phase 4: ms per call of the viewport blit alone, [batch, h, w, 4]
    f32 -> [batch, vh, vw, 3] u8, as the engine's finalize runs it."""
    import jax
    import jax.numpy as jnp

    from retrocapture_tpu.ops.sampling import resize_linear

    vw, vh = viewport
    blit = jax.jit(
        lambda t: jnp.round(
            jnp.clip(resize_linear(t[..., :3], vw, vh), 0.0, 1.0) * 255.0
        ).astype(jnp.uint8)
    )
    rng = np.random.default_rng(SEED)
    xs = [jnp.asarray(rng.random((batch, h, w, 4), np.float32)) for _ in range(2)]
    blit(xs[0]).block_until_ready()
    t0 = time.perf_counter()
    out = None
    for i in range(n_timed):
        out = blit(xs[i % 2])
    out.block_until_ready()
    return 1e3 * (time.perf_counter() - t0) / n_timed


def check_onehot_exact(h: int, w: int, viewport) -> dict:
    """Phase 5: the DEFAULT-precision one-hot matmuls stay exact on the
    device — a NEAREST resample of an RGBA8-grid texture (one-hot
    matmul + requant) and a one-hot selection of x255 integers (the
    xbr-lv2 form) both equal their numpy references bit for bit."""
    import jax
    import jax.numpy as jnp

    from retrocapture_tpu.ops.sampling import reference_sample2d_numpy, sample2d

    vw, vh = viewport
    rng = np.random.default_rng(SEED)
    k = rng.integers(0, 256, (h, w, 4))
    tex = (k * np.float32(1.0 / 255.0)).astype(np.float32)
    u = ((np.arange(vw) + 0.5) / vw).astype(np.float32)
    v = ((np.arange(vh) + 0.5) / vh).astype(np.float32)
    uu, vv = np.meshgrid(u, v)
    got = np.asarray(
        jax.jit(
            lambda t: sample2d(t, uu, vv, filter_linear=False, quantized_u8=True)
        )(jnp.asarray(tex))
    )
    want = reference_sample2d_numpy(
        tex, uu, vv, filter_linear=False, wrap_mode="clamp_to_edge"
    )
    requant_exact = bool(np.array_equal(got, want))

    idx = rng.integers(0, h, vh)
    onehot = (np.arange(h)[None, :] == idx[:, None]).astype(np.float32)
    ints = k[..., :3].astype(np.float32)
    sel = np.asarray(
        jax.jit(
            lambda a, b: jnp.einsum(
                "Hs,swc->Hwc", a, b, precision=jax.lax.Precision.DEFAULT
            )
        )(jnp.asarray(onehot), jnp.asarray(ints))
    )
    x255_exact = bool(np.array_equal(sel, ints[idx]))
    if not (requant_exact and x255_exact):
        raise RuntimeError(
            f"one-hot DEFAULT matmul not exact: requant={requant_exact} "
            f"x255={x255_exact}"
        )
    return {"onehot_requant_exact": requant_exact, "onehot_x255_exact": x255_exact}


def run_chain(
    name: str, preset: str, fmt: str, bar: dict, *, hw, viewport, batch: int,
    n_ref: int, n_timed: int, device, ref_device,
) -> dict:
    """All per-chain phases for one chain at the given sizes."""
    import jax

    h, w = hw
    frames = make_frames(fmt, batch * 2, h, w)
    with jax.default_device(device):
        batches = [jax.device_put(frames[:batch]), jax.device_put(frames[batch:])]
        eng = new_engine(preset, fmt, viewport)
        timing = time_chain(eng, batches, n_timed, device)
        passthrough = np.asarray(
            new_engine(None, fmt, viewport).apply(batches[0], output="u8")
        )
    active = check_active(eng, timing.pop("first_out"), passthrough)
    ref = compare_reference(
        preset, fmt, frames[:n_ref], viewport, device, ref_device, bar
    )
    return {"chain": name, "input": fmt, **active, **ref, **timing}


def _fmt(v) -> str:
    if isinstance(v, float):
        return repr(v)
    return str(v)


def main(argv=None) -> int:
    import jax

    import retrocapture_tpu  # noqa: F401 - fail fast outside a checkout

    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        # The reference engine runs on the CPU device of this process.
        jax.config.update("jax_platforms", platforms + ",cpu")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(
            f"chip_smoke: needs a GPU; JAX found platform {dev.platform!r} "
            f"({dev.device_kind})",
            file=sys.stderr,
        )
        return 2
    cpu = jax.devices("cpu")[0]
    card = card_line()
    print(f"card: {card}", flush=True)
    h, w = SOURCE_HW
    vw, vh = VIEWPORT
    step_ms = {}
    for name, preset, fmt, bar in CHAINS:
        res = run_chain(
            name, preset, fmt, bar, hw=SOURCE_HW, viewport=VIEWPORT, batch=BATCH,
            n_ref=REF_FRAMES, n_timed=TIMED_BATCHES, device=dev, ref_device=cpu,
        )
        step_ms[name] = res["step_ms"]
        print(
            f"[{card}] {name} {w}x{h}->{vw}x{vh} batch {BATCH}: "
            + " ".join(f"{k}={_fmt(v)}" for k, v in res.items() if k != "chain"),
            flush=True,
        )
    exact = check_onehot_exact(h, w, VIEWPORT)
    print(f"[{card}] precision: " + " ".join(f"{k}={v}" for k, v in exact.items()))
    blit_ms = time_blit(BATCH, h, w, VIEWPORT, TIMED_BATCHES)
    share = blit_ms / step_ms["feedback-ghost"]
    print(
        f"[{card}] blit [{BATCH},{h},{w},4] f32 -> [{BATCH},{vh},{vw},3] u8: "
        f"blit_ms={blit_ms!r} share_of_feedback_ghost_step={share!r}",
        flush=True,
    )
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
