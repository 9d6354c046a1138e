"""GL parity sweep: PSNR of Engine vs the real-GL oracle across corpus
presets. The broad-coverage companion to tests/test_gl_parity.py.

    python tools/gl_parity_sweep.py [--limit N] [--filter SUBSTR]
        [--out gl_parity.json] [--frames 2]

Each preset renders the SMPTE test pattern through both paths at
320x240 -> 640x480 and reports PSNR (inf = bit-exact). Presets that fail
to load/execute in either path are recorded as such, not crashed on.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import os

# Parity harness mode: FrameCount/Time concrete per frame (one retrace
# per frame) so time-dependent math folds through the exact numpy path,
# mirroring the reference where uniforms are concrete per draw call.
os.environ.setdefault("RCTPU_CONCRETE_FC", "1")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHADERS = Path("/root/reference/shaders/shaders_glsl")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--filter", default="")
    ap.add_argument("--out", default="gl_parity.json")
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--skip-from", default="", metavar="CORPUS_JSON",
                    help="skip presets whose corpus status is timeout "
                    "(XLA-CPU-compile monsters, checked separately)")
    args = ap.parse_args()

    from retrocapture_tpu import Engine
    from retrocapture_tpu.io.testpattern import TestPatternSource
    from retrocapture_tpu.parity import OracleEngine, psnr

    frame = TestPatternSource(320, 240).capture_frame()
    presets = sorted(SHADERS.rglob("*.glslp"))
    skip = set()
    if args.skip_from:
        import json as _json
        for rec in _json.load(open(args.skip_from)):
            if rec.get("status") == "timeout":
                skip.add(rec["preset"])
        presets = [p for p in presets if str(p.relative_to(SHADERS)) not in skip]
    if args.filter:
        presets = [p for p in presets if args.filter in str(p)]
    if args.limit:
        presets = presets[: args.limit]

    results = []
    t0 = time.time()
    for i, path in enumerate(presets):
        rel = str(path.relative_to(SHADERS))
        rec = {"preset": rel}
        try:
            o = OracleEngine(viewport=(640, 480))
            o.load_preset(str(path))
            e = Engine(viewport=(640, 480))
            if not e.load_preset(str(path)):
                raise RuntimeError(f"engine load: {e.last_error}")
            gl = ours = None
            for _ in range(args.frames):
                gl = o.apply(frame)
                ours = np.asarray(e.apply(frame))
            p = psnr(gl, ours)
            rec["psnr"] = round(p, 2) if np.isfinite(p) else "inf"
            o._oracle.close()
        except Exception as ex:  # noqa: BLE001
            rec["error"] = f"{type(ex).__name__}: {str(ex)[:160]}"
        results.append(rec)
        if (i + 1) % 25 == 0:
            Path(args.out).write_text(json.dumps(results, indent=1))
        if (i + 1) % 10 == 0:
            done = [r for r in results if "psnr" in r]
            vals = [r["psnr"] for r in done if r["psnr"] != "inf"]
            exact = sum(1 for r in done if r["psnr"] == "inf")
            med = float(np.median(vals)) if vals else 0
            print(
                f"[{i+1}/{len(presets)}] ok={len(done)} exact={exact} "
                f"median={med:.1f}dB ({time.time()-t0:.0f}s)",
                flush=True,
            )

    Path(args.out).write_text(json.dumps(results, indent=1))
    done = [r for r in results if "psnr" in r]
    vals = [r["psnr"] for r in done if r["psnr"] != "inf"]
    exact = sum(1 for r in done if r["psnr"] == "inf")
    print(
        f"DONE: {len(done)}/{len(results)} compared, {exact} bit-exact, "
        f"{sum(1 for v in vals if v >= 50)} at >=50dB, "
        f"median {np.median(vals):.1f}dB" if vals else "DONE (no comparisons)"
    )
    worst = sorted((r for r in done if r["psnr"] != "inf"), key=lambda r: r["psnr"])[:15]
    for r in worst:
        print(f"  {r['psnr']:7.2f}  {r['preset']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
