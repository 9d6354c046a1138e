"""Benchmark harness — prints ONE JSON line.

Measures steady-state 1080p-viewport frames/sec on one GPU over the
BASELINE configs (BASELINE.json):

  1. single-pass scanline, 320x240 source (smoke-test golden path)
  2. xbr-lv2 upscale, 240p source -> 1080p
  3. crt-mattias CRT chain at 1080p
  4. ntsc-320px multi-pass composite (frame_count_mod temporal state)
  5. PassFeedback ghost preset on a batched frame stream with the
     NV12->RGB convert fused into the chain's single XLA program
     (Engine.set_input_format)

Metric: geometric mean frames/sec across configs. Each config also
reports single-frame p50/p95 latency (batch-1 submit -> result ready)
and min/median/max window throughput so variance is visible. Every
result names the device it ran on (platform, device_kind, device count,
and the card's name and power limit from nvidia-smi).

Each config runs in its own child process, one at a time; the parent
never touches JAX, so one process holds the card. A config whose preset
is missing, or a run without a GPU, is an error and the run exits
nonzero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SHADERS = Path("/root/reference/shaders/shaders_glsl")

CONFIGS = [
    # (name, preset path, source (h, w), batch, input_format). The batch
    # per config is carried over from earlier rounds unchanged; each
    # config's knee on the GPU is still to be found.
    ("feedback-ghost-nv12", REPO / "assets/presets/feedback-ghost.glslp", (240, 320), 128, "nv12"),
    ("ntsc-320px", SHADERS / "ntsc/ntsc-320px.glslp", (240, 320), 128, "rgb"),
    ("scanline-320", SHADERS / "interpolation/sharp-bilinear-scanlines.glslp", (240, 320), 128, "rgb"),
    ("xbr-lv2-1080p", SHADERS / "xbr/xbr-lv2.glslp", (240, 320), 64, "rgb"),
    # 240p source (the CRT-shader operating point: the app feeds CRT
    # chains a logical-resolution downscale, FrameCapturePipeline.cpp:142)
    # rendered at a 1080p viewport.
    ("crt-mattias-1080p", SHADERS / "crt/crt-mattias.glslp", (240, 320), 32, "rgb"),
]

VIEWPORT = (1920, 1080)  # (W, H)


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def _make_producer(rng, shape, batch, fmt):
    import jax
    import jax.numpy as jnp

    h, w = shape
    counter = [0]
    if fmt == "nv12":
        raw = jnp.asarray(
            (rng.random((batch, h + h // 2, w)) * 255).astype(np.uint8)
        )
    else:
        raw = jnp.asarray((rng.random((batch, h, w, 3)) * 255).astype(np.uint8))
    # Every call gets genuinely different input (xor with a changing
    # scalar, on device).
    vary = jax.jit(lambda f, k: f ^ k)

    def produce(n=None):
        counter[0] += 1
        out = vary(raw, jnp.uint8(counter[0] % 251))
        return out[:n] if n is not None else out

    return produce


def bench_config(name, preset, shape, batch, fmt, *, iters=16, warmup=2):
    import jax

    from retrocapture_tpu.runtime.engine import Engine

    dev = jax.devices()[0]
    device = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": _card(),
    }
    if dev.platform != "gpu":
        return {"name": name, "error": f"no GPU: JAX found {dev.platform!r}", **device}
    if not Path(preset).is_file():
        return {"name": name, "error": f"preset not found: {preset}", **device}

    rng = np.random.default_rng(0)
    e = Engine(viewport=VIEWPORT)
    if not e.load_preset(str(preset)):
        return {"name": name, "error": e.last_error, **device}
    e.set_input_format(fmt)
    produce = _make_producer(rng, shape, batch, fmt)

    # Output is device-side uint8 — the reference's data product (RGBA8
    # FBO + PBO readback); the final blit fuses resample+quantize.
    t_compile = time.perf_counter()
    e.apply(produce(), output="u8").block_until_ready()
    t_compile = time.perf_counter() - t_compile
    for _ in range(warmup - 1):
        e.apply(produce(), output="u8").block_until_ready()
    if not e.shader_active:
        return {"name": name, "error": f"passthrough degrade: {e.last_error}", **device}

    # Throughput: each window enqueues `iters` calls and ends in
    # block_until_ready on the last output; engine state chains call i
    # into i+1, so that waits for the whole window.
    window_fps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = e.apply(produce(), output="u8")
        out.block_until_ready()
        window_fps.append(iters * batch / (time.perf_counter() - t0))
    window_fps.sort()

    # Latency: one frame submitted, result ready on the device.
    lat = []
    e.apply(produce(1), output="u8").block_until_ready()  # warm batch-1
    for _ in range(15):
        t0 = time.perf_counter()
        e.apply(produce(1), output="u8").block_until_ready()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()

    best_fps = window_fps[-1]
    return {
        "name": name,
        "fps": best_fps,
        "ms_per_frame": 1000.0 / best_fps,
        "fps_windows_min_med_max": [
            window_fps[0], window_fps[len(window_fps) // 2], window_fps[-1]
        ],
        "latency_p50_ms": lat[len(lat) // 2],
        "latency_p95_ms": lat[min(len(lat) - 1, int(len(lat) * 0.95))],
        "compile_s": t_compile,
        "batch": batch,
        **device,
    }


def _run_one(name) -> dict:
    for cfg in CONFIGS:
        if cfg[0] == name:
            n, preset, shape, batch, fmt = cfg
            try:
                return bench_config(n, preset, shape, batch, fmt)
            except Exception as ex:  # noqa: BLE001 - reported per config
                return {"name": n, "error": f"{type(ex).__name__}: {ex}"}
    return {"name": name, "error": "unknown config"}


def _summary_line(results) -> str:
    ok = [r for r in results if "fps" in r]
    geo = float(np.exp(np.mean(np.log([r["fps"] for r in ok])))) if ok else 0.0
    return json.dumps({
        "metric": (
            "1080p shader-chain frames/sec (geomean of "
            f"{len(ok)} of {len(CONFIGS)} BASELINE configs)"
        ),
        "value": geo if len(ok) == len(CONFIGS) else None,
        "unit": "frames/sec",
        "configs_ok": len(ok),
        "configs_total": len(CONFIGS),
        "configs": results,
    })


def main() -> int:
    import os

    # Deterministic hashing in the per-config children: Python hash
    # randomization leaks set/dict iteration order into the traced HLO's
    # instruction spelling, which flips the XLA cache key between
    # processes.
    os.environ.setdefault("PYTHONHASHSEED", "0")

    if len(sys.argv) > 2 and sys.argv[1] == "--config":
        r = _run_one(sys.argv[2])
        print(json.dumps(r))
        return 0 if "fps" in r else 1

    results = []
    for name, *_ in CONFIGS:
        out = subprocess.run(
            [sys.executable, __file__, "--config", name],
            capture_output=True, text=True,
        )
        line = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
        r = json.loads(line) if line.startswith("{") else {
            "name": name,
            "error": f"rc={out.returncode}: {out.stderr[-300:]}",
        }
        results.append(r)
        print(f"# {r}", file=sys.stderr, flush=True)

    print(_summary_line(results))
    return 0 if all("fps" in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
