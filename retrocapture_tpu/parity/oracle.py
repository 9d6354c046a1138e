"""Real-GL parity oracle.

``GLOracle`` drives the native ``gloracle`` worker (native/gloracle): a
headless Mesa-llvmpipe GL context that compiles each pass with the real
GL compiler and renders it with real GL filtering/FBO formats.
``OracleEngine`` mirrors the JAX Engine's multi-pass chain through it —
same preset parsing, same shapes (graph/scale.py), same uniform/sampler
protocol (graph/plan.PassContext) — so ``Engine.apply`` output can be
PSNR-checked against genuine GL output for ANY corpus preset, which is
the "PSNR >= 50 dB vs the GL reference" acceptance test (BASELINE.json)
made runnable without a GPU.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from retrocapture_tpu.frontend.cpp import preprocess
from retrocapture_tpu.graph.plan import PassContext, TexBinding, compile_preset
from retrocapture_tpu.graph.scale import compute_chain_shapes
from retrocapture_tpu.presets.glslp import Preset
from retrocapture_tpu.frontend.values import TYPE_NAMES

__all__ = ["GLOracle", "OracleEngine", "psnr"]

_BIN = Path(__file__).resolve().parents[2] / "native" / "gloracle" / "gloracle"

MAX_FRAME_HISTORY = 7


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(1.0 / mse))


def _ensure_built() -> Path:
    if not _BIN.is_file():
        subprocess.run(
            ["make", "-C", str(_BIN.parent)], check=True, capture_output=True, timeout=180
        )
    return _BIN


class GLOracle:
    """Persistent gloracle worker process."""

    def __init__(self):
        env = dict(os.environ)
        env["LIBGL_ALWAYS_SOFTWARE"] = "1"
        self._proc = subprocess.Popen(
            [str(_ensure_built())],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            env=env,
        )

    def run_pass(
        self,
        vs: str,
        fs: str,
        out_w: int,
        out_h: int,
        *,
        textures: list[tuple[str, np.ndarray, bool, str, bool]],
        uniforms: list[tuple[str, str, list[float]]],
        fbo: str = "rgba8",
    ) -> np.ndarray:
        """Run one pass. textures: (name, [H,W,4] f32, linear, wrap,
        mipmap). uniforms: (name, kind, values). Returns [out_h,out_w,4]
        f32 (row 0 = v==0, texture convention)."""
        header = {
            "vs": vs,
            "fs": fs,
            "out_w": int(out_w),
            "out_h": int(out_h),
            "fbo": fbo,
            "textures": [
                {
                    "name": n,
                    "w": int(t.shape[1]),
                    "h": int(t.shape[0]),
                    "linear": bool(lin),
                    "wrap": wrap,
                    "mipmap": bool(mip),
                }
                for n, t, lin, wrap, mip in textures
            ],
            "uniforms": [
                {"name": n, "kind": k, "v": [float(x) for x in v]}
                for n, k, v in uniforms
            ],
        }
        hb = json.dumps(header).encode()
        p = self._proc
        p.stdin.write(struct.pack("<I", len(hb)))
        p.stdin.write(hb)
        for _, t, _, _, _ in textures:
            p.stdin.write(np.ascontiguousarray(t, np.float32).tobytes())
        p.stdin.flush()
        status = struct.unpack("<I", p.stdout.read(4))[0]
        plen = struct.unpack("<I", p.stdout.read(4))[0]
        payload = p.stdout.read(plen)
        if status != 0:
            raise RuntimeError(f"gloracle: {payload.decode(errors='replace')}")
        out = np.frombuffer(payload, np.float32).reshape(out_h, out_w, 4)
        return out.copy()

    def close(self):
        if self._proc.poll() is None:
            self._proc.stdin.close()
            self._proc.wait(timeout=5)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class OracleEngine:
    """ShaderEngine-shaped execution through real GL, mirroring
    runtime/engine._run_chain pass for pass."""

    def __init__(self, viewport: Optional[tuple[int, int]] = None):
        self._oracle = GLOracle()
        self._program = None
        self._sources: list[tuple[str, str]] = []  # preprocessed (vs, fs)
        self._custom_params: dict[str, float] = {}
        self._viewport = viewport
        self.frame_count = 0
        self.time = 0.0
        self._history: list[np.ndarray] = []
        self._feedback: dict[int, np.ndarray] = {}

    def load_preset(self, path: str) -> bool:
        if str(path).endswith(".glsl"):
            preset = Preset.loads(f"shaders = 1\nshader0 = {path}\n", path=str(path))
        else:
            preset = Preset.load(path)
        self._program = compile_preset(preset)
        self._sources = []
        from retrocapture_tpu.graph.plan import _compat_rewrites

        for i, cfg in enumerate(preset.passes):
            src = Path(cfg.shader_path).read_text(encoding="utf-8", errors="replace")
            # Same per-shader compatibility injections the reference's
            # ShaderPreprocessor applies before its GL compile
            # (ShaderPreprocessor.cpp:527-634) — the oracle must render
            # the shader the reference actually runs (box-center's
            # border test black-screens otherwise).
            src = _compat_rewrites(src, cfg.shader_path, cfg)
            vs, _ = preprocess(src, "vertex", filename=cfg.shader_path)
            fs, _ = preprocess(src, "fragment", filename=cfg.shader_path)
            vs = self._zero_init_varyings(vs, self._program.passes[i])
            # The real GLSL compiler needs the #version line our parser
            # strips; compatibility profile accepts both legacy and
            # modern constructs in one context. 430 for arrays-of-arrays
            # and 420pack C-style initializers (bayer dither,
            # phosphorlut, powervr2 families).
            pre = "#version 430 compatibility\n"
            self._sources.append((pre + vs, pre + fs))
        self.reset_state()
        return True

    @staticmethod
    def _zero_init_varyings(vs: str, cp) -> str:
        """Write zeros to every declared varying at vertex main entry.

        GLSL leaves never-written varyings UNDEFINED; llvmpipe hands the
        fragment garbage while most desktop drivers hand it zeros.
        crt-royale's mask-resize vertex shadows its ``tile_uv_wrap``
        varying with a local const, so the varying is never written and
        the whole mask pipeline black-screens on llvmpipe. The engine's
        evaluator (like RetroArch in practice) reads such varyings as 0
        — pin the oracle to the same defined behavior. Properly written
        shaders just overwrite the zeros."""
        import re

        from retrocapture_tpu.frontend.values import TYPE_NAMES

        inits = []
        for g in cp.vertex_eval.tu.globals():
            if not g.type.is_varying_out:
                continue
            t = g.type.name
            if TYPE_NAMES.get(t) is None:
                continue
            for d in g.declarators:
                if d.array_size is None:
                    inits.append(f"    {d.name} = {t}(0);")
        if not inits:
            return vs
        block = "\n" + "\n".join(inits) + "\n"
        return re.sub(
            r"void\s+main\s*\(\s*(void)?\s*\)\s*\{",
            lambda m: m.group(0) + block,
            vs,
            count=1,
        )

    def set_parameter(self, name: str, value: float) -> bool:
        if self._program is None or name not in self._program.parameters:
            return False
        self._custom_params[name] = float(value)
        return True

    def reset_state(self):
        self.frame_count = 0
        self.time = 0.0
        self._history = []
        self._feedback = {}

    # ------------------------------------------------------------------
    def apply(self, frame: np.ndarray) -> np.ndarray:
        """uint8/float [H,W,3|4] -> float32 RGB [vh,vw,3]."""
        arr = np.asarray(frame)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        arr = arr.astype(np.float32)
        if arr.shape[-1] == 3:
            arr = np.concatenate([arr, np.ones(arr.shape[:-1] + (1,), np.float32)], -1)
        h, w = arr.shape[:2]
        vw, vh = self._viewport or (w, h)
        if getattr(self, "_compile_failed", False):
            final = arr
            if final.shape[0] != vh or final.shape[1] != vw:
                final = _resize_bilinear_np(final, vw, vh)
            return final[..., :3]
        prog = self._program
        preset = prog.preset
        shapes = compute_chain_shapes(preset, w, h, vw, vh)
        n = len(prog.passes)

        params = dict(prog.defaults)
        params.update(self._custom_params)

        def filter_of_output(j: int) -> tuple[bool, str, bool]:
            if j + 1 < n:
                cfg = preset.passes[j + 1]
                return cfg.filter_linear, cfg.wrap_mode, cfg.mipmap_input
            return True, "clamp_to_edge", False

        original = TexBinding(
            arr,
            preset.passes[0].filter_linear,
            preset.passes[0].wrap_mode,
            preset.passes[0].mipmap_input,
        )
        if prog.uses_history() and not self._history:
            # Cold ring: the reference leaves unfilled PrevN samplers
            # unbound → texture unit 0 → the pass input
            # (ShaderEngine.cpp:1137-1155).  Mirror the engine's static-
            # shape approximation: seed every slot with the first frame
            # pushed through the history-entry path (resize + RGBA8).
            hh, hw = shapes[-1].out_h, shapes[-1].out_w
            entry = arr
            if entry.shape[:2] != (hh, hw):
                entry = _resize_bilinear_np(entry, hw, hh)
            entry = np.round(np.clip(entry, 0, 1) * 255.0) / 255.0
            entry = entry.astype(np.float32)
            self._history = [entry] * MAX_FRAME_HISTORY
        history_b = [TexBinding(t, True, "clamp_to_edge") for t in self._history]

        pass_outputs: list[Optional[TexBinding]] = []
        outputs_raw: list[np.ndarray] = []
        current = arr
        for i, cp in enumerate(prog.passes):
            cfg = preset.passes[i]
            sh = shapes[i]
            input_b = TexBinding(
                current, cfg.filter_linear, cfg.wrap_mode, cfg.mipmap_input
            )
            fb_b = {
                j: TexBinding(t, *filter_of_output(j)) for j, t in self._feedback.items()
            }
            ctx = PassContext(
                prog,
                i,
                shapes=shapes,
                viewport=(vw, vh),
                source_size=(w, h),
                input_binding=input_b,
                original_binding=original,
                pass_outputs=pass_outputs,
                history=history_b,
                feedback=fb_b,
                frame_count=np.int32(self.frame_count),
                frame_time=np.float32(self.time),
                params={k: np.float32(v) for k, v in params.items()},
            )
            try:
                out = self._run_gl_pass(cp, ctx, cfg, sh)
            except RuntimeError:
                # A pass the real GLSL compiler rejects (e.g. reshade/
                # bloom's later passes reference parameters only pass 0
                # declares): the reference degrades the WHOLE chain to
                # passthrough on any pass compile failure
                # (ShaderEngine.cpp:294-314). Mirror that so both sides
                # present the same degraded output.
                self._compile_failed = True
                final = arr
                if final.shape[0] != vh or final.shape[1] != vw:
                    final = _resize_bilinear_np(final, vw, vh)
                return final[..., :3]
            outputs_raw.append(out)
            pass_outputs.append(TexBinding(out, *filter_of_output(i)))
            current = out

        final = current

        # history ring (quantized to RGBA8 like the GL copy)
        if prog.uses_history():
            hh, hw = (self._history[0].shape[:2] if self._history else final.shape[:2])
            entry = final
            if entry.shape[:2] != (hh, hw):
                entry = _resize_bilinear_np(entry, hw, hh)
            entry = np.round(np.clip(entry, 0, 1) * 255.0) / 255.0
            self._history = [entry] + self._history[: MAX_FRAME_HISTORY - 1]

        if prog.uses_feedback():
            self._feedback = {j: outputs_raw[j] for j in range(n)}

        self.frame_count += 1
        self.time += 1.0 / 60.0

        if final.shape[0] != vh or final.shape[1] != vw:
            final = _resize_bilinear_np(final, vw, vh)
        return final[..., :3]

    # ------------------------------------------------------------------
    def _run_gl_pass(self, cp, ctx: PassContext, cfg, sh) -> np.ndarray:
        textures: list[tuple[str, np.ndarray, bool, str, bool]] = []
        uniforms: list[tuple[str, str, list[float]]] = []
        seen_tex: set[str] = set()
        seen_uni: set[str] = set()

        for tu in (cp.vertex_eval.tu, cp.fragment_eval.tu):
            for g in tu.globals():
                ts = g.type
                for d in g.declarators:
                    name = d.name
                    if ts.name.startswith("sampler"):
                        if name in seen_tex:
                            continue
                        b = ctx._resolve_binding(name)
                        if b is None:
                            continue
                        tex = np.asarray(b.tex, np.float32)
                        textures.append(
                            (name, tex, b.filter_linear, b.wrap_mode, b.mipmap)
                        )
                        seen_tex.add(name)
                        continue
                    if not ts.is_uniform or name in seen_uni:
                        continue
                    seen_uni.add(name)
                    if ts.name in cp.vertex_eval.structs or ts.name in cp.fragment_eval.structs:
                        sd = (cp.vertex_eval.structs.get(ts.name)
                              or cp.fragment_eval.structs.get(ts.name))
                        sv = ctx.resolve_struct_uniform(name, sd.fields)
                        if sv is None:
                            continue
                        for fname, fv in sv.fields.items():
                            uniforms.append(_uniform_entry(f"{name}.{fname}", fv))
                        continue
                    gtype = TYPE_NAMES.get(ts.name)
                    if gtype is None:
                        continue
                    v = ctx.resolve_uniform(name, gtype)
                    if v is None:
                        continue
                    uniforms.append(_uniform_entry(name, v))

        fbo = (
            "rgba32f"
            if cfg.float_framebuffer
            else ("srgb8" if cfg.srgb_framebuffer else "rgba8")
        )
        vs, fs = self._sources[cp.index]
        try:
            out = self._oracle.run_pass(
                vs,
                fs,
                sh.out_w,
                sh.out_h,
                textures=textures,
                uniforms=uniforms,
                fbo=fbo,
            )
        except RuntimeError as exc:
            # The reference auto-repairs `vec3 x = COMPAT_TEXTURE(...)`
            # type errors by source rewriting + recompile
            # (ShaderEngine.cpp:450-530): lenient desktop drivers accept
            # the implicit vec4→vec3 truncation these shaders rely on,
            # strict Mesa GLSL does not. Appending `.xyz` to the
            # initializer implements the truncation semantics without
            # changing the variable's type (the reference's vec4
            # redeclaration breaks downstream vec4(x, 1.0) constructors
            # on strict compilers).
            fixed = _repair_vec3_texture_init(fs)
            if fixed == fs:
                raise
            self._sources[cp.index] = (vs, fixed)
            out = self._oracle.run_pass(
                vs,
                fixed,
                sh.out_w,
                sh.out_h,
                textures=textures,
                uniforms=uniforms,
                fbo=fbo,
            )
        if fbo == "srgb8":
            # glReadPixels returns the STORED (sRGB-encoded) bytes; a GL
            # sampler of the SRGB8 texture would decode to linear, and the
            # chain passes linear float textures between passes.
            rgb = out[..., :3]
            rgb = np.where(
                rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4
            ).astype(np.float32)
            out = np.concatenate([rgb, out[..., 3:4]], axis=-1)
        return out


def _uniform_entry(name: str, v) -> tuple[str, str, list[float]]:
    data = np.asarray(v.data, np.float64).reshape(-1)
    base = v.type.base
    if v.type.is_matrix:
        # V stores [cols, rows]; flattening is already GL column-major.
        return (name, "m4", list(np.asarray(v.data, np.float64).reshape(-1)))
    if v.type.is_scalar:
        return (name, "i" if base in ("int", "uint") else "f", [float(data[0])])
    n = v.type.shape[0]
    return (name, f"{n}f", [float(x) for x in data[:n]])


def _resize_bilinear_np(tex: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    h, w = tex.shape[:2]
    u = (np.arange(out_w, dtype=np.float64) + 0.5) / out_w * w - 0.5
    v = (np.arange(out_h, dtype=np.float64) + 0.5) / out_h * h - 0.5
    x0 = np.floor(u).astype(int)
    y0 = np.floor(v).astype(int)
    fx = (u - x0)[None, :, None]
    fy = (v - y0)[:, None, None]
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    t00 = tex[y0c][:, x0c]
    t01 = tex[y0c][:, x1c]
    t10 = tex[y1c][:, x0c]
    t11 = tex[y1c][:, x1c]
    top = t00 + (t01 - t00) * fx
    bot = t10 + (t11 - t10) * fx
    return (top + (bot - top) * fy).astype(np.float32)


def _repair_vec3_texture_init(src: str) -> str:
    """Rewrite ``vec3 x = texture*(...)`` to ``vec3 x = texture*(...).xyz``
    (balanced-paren scan), implementing the implicit vec4→vec3
    truncation lenient drivers grant these shaders."""
    import re

    out = []
    pos = 0
    pat = re.compile(
        r"\bvec3\s+\w+\s*=\s*(?:COMPAT_TEXTURE|texture2D|texture)\s*\("
    )
    while True:
        m = pat.search(src, pos)
        if m is None:
            out.append(src[pos:])
            break
        depth = 1
        i = m.end()
        while i < len(src) and depth:
            if src[i] == "(":
                depth += 1
            elif src[i] == ")":
                depth -= 1
            i += 1
        out.append(src[pos:i])
        out.append(".xyz")
        pos = i
    return "".join(out)
