"""Preset compilation and the per-pass binding model.

``compile_preset`` turns a parsed ``Preset`` into a ``PresetProgram``:
each pass's GLSL is preprocessed and parsed once, LUT PNGs are loaded,
and the runtime parameter table is merged with the reference's precedence
(custom > preset-file override > pragma default —
ShaderEngine::getShaderParameters, ShaderEngine.cpp:3264).

``PassContext`` implements the RetroArch uniform/sampler protocol the
reference applies in renderMultipassPass/setupUniforms (the ~40 uniform
families catalogued in SURVEY.md §2.1):

* input sampler under Texture/Source/Input/s_p/tex/image — and any
  *unbound* sampler2D also resolves to the input, because GL sampler
  uniforms default to texture unit 0 where the input is bound (this is
  how shaders like xbr-lv2's ``decal`` work);
* pass 0 history: PrevTexture / Prev{1..6}Texture / PassPrev#Texture;
* later passes: PassPrev<N>Texture = output of pass i-N (N>i = original
  input), PrevTexture = pass 0 output, Prev{k}Texture = pass k output;
* aliases (aliasN = Name → sampler Name + vec4 NameSize);
* PassFeedback<N>[Texture] = previous frame's pass-N output;
* OrigTexture = original input; LUTs by preset name;
* size/frame-state uniform families (SourceSize, OutputSize vec2/3/4 by
  declared type, TextureSize=InputSize=input size, OriginalHistorySize#,
  FrameCount with frame_count_mod, MVPMatrix, …).

GL texture-state fidelity: the reference sets filter/wrap only on the
*bound input* texture each pass (ShaderEngine.cpp:1004-1036), so a pass
output later sampled via PassPrev keeps the filter of the pass that
consumed it as input (pass j+1); FBO textures default to LINEAR +
clamp_to_edge (createFramebuffer :2902-2904). We replicate that rule.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np

from retrocapture_tpu.frontend.cpp import PragmaParameter, preprocess
from retrocapture_tpu.frontend.glsl_parser import parse
from retrocapture_tpu.frontend.interp import ShaderEval
from retrocapture_tpu.frontend.values import (
    FLOAT,
    GType,
    INT,
    SamplerVal,
    StructVal,
    V,
)
from retrocapture_tpu.graph.scale import PassShapes
from retrocapture_tpu.presets.glslp import Preset

__all__ = ["PresetProgram", "CompiledPass", "PassContext", "compile_preset", "TexBinding"]

_INPUT_SAMPLER_NAMES = ("Texture", "Source", "Input", "s_p", "tex", "image")

# Hardcoded legacy fallback defaults (ShaderEngine.cpp:2258-2375) applied
# when a shader samples a tweak uniform that has no pragma and no preset
# override (zfast_crt, Afterglow, resswitch etc.).
LEGACY_PARAM_DEFAULTS: dict[str, float] = {
    "BLURSCALEX": 0.30,
    "LOWLUMSCAN": 6.0,
    "HILUMSCAN": 8.0,
    "BRIGHTBOOST": 1.25,
    "MASK_DARK": 0.25,
    "MASK_FADE": 0.8,
    "RESSWITCH_ENABLE": 1.0,
    "RESSWITCH_GLITCH_TRESHOLD": 0.1,
    "RESSWITCH_GLITCH_BAR_STR": 0.6,
    "RESSWITCH_GLITCH_BAR_SIZE": 0.5,
    "RESSWITCH_GLITCH_BAR_SMOOTH": 1.0,
    "RESSWITCH_GLITCH_SHAKE_MAX": 0.25,
    "RESSWITCH_GLITCH_ROT_MAX": 0.2,
    "RESSWITCH_GLITCH_WOB_MAX": 0.1,
    "AS": 0.20,
    "asat": 0.33,
    "PR": 0.32,
    "PG": 0.32,
    "PB": 0.32,
}

_PASSPREV_TEX_RE = re.compile(r"^PassPrev(\d+)Texture$")
_PREVK_TEX_RE = re.compile(r"^Prev(\d*)Texture$")
_FEEDBACK_RE = re.compile(r"^PassFeedback(\d+)(Texture)?$")
_PASSPREV_SIZE_RE = re.compile(r"^PassPrev(\d+)(TextureSize|InputSize|OutputSize)$")
_PASS_SIZE_RE = re.compile(r"^Pass(Output|Input)Size(\d+)$")
_HISTORY_SIZE_RE = re.compile(r"^OriginalHistorySize(\d+)$")


@dataclass
class LutTexture:
    name: str
    data: np.ndarray  # [H, W, 4] float32
    linear: bool
    wrap_mode: str
    mipmap: bool


@dataclass
class CompiledPass:
    index: int
    vertex_eval: ShaderEval
    fragment_eval: ShaderEval
    parameters: list[PragmaParameter]
    # Names this pass's fragment+vertex reference (for temporal-state
    # detection and binding checks).
    sampler_names: tuple[str, ...]
    texture_calls: int = 0  # static texture() sites (diagnostic only)
    # Conservative (token-level) temporal-uniform usage, detected on the
    # preprocessed source: drives the fc-period batch grouping in
    # runtime/engine. Over-approximation only disables an optimization.
    uses_frame_count: bool = False
    uses_time: bool = False


@dataclass
class PresetProgram:
    preset: Preset
    passes: list[CompiledPass]
    luts: dict[str, LutTexture]
    # name → (pragma meta, effective default after preset override)
    parameters: dict[str, PragmaParameter]
    defaults: dict[str, float]

    def uses_history(self) -> bool:
        for cp in self.passes:
            for n in cp.sampler_names:
                if _PREVK_TEX_RE.match(n):
                    return True
                if cp.index == 0 and _PASSPREV_TEX_RE.match(n):
                    return True
        return False

    def uses_feedback(self) -> bool:
        return any(
            _FEEDBACK_RE.match(n) for cp in self.passes for n in cp.sampler_names
        )

    def fc_period(self) -> "Optional[int]":
        """Period m such that the chain's output depends on FrameCount
        only through FrameCount % m, or None when unbounded.

        The reference hands each pass `FrameCount % frame_count_modN`
        (ShaderEngine.cpp:2095-2145), so when every FrameCount-consuming
        pass declares a mod — and no pass consumes Time — the whole
        chain is periodic in FrameCount with period lcm(mods). m == 1
        means the chain is frame-count-free entirely. The engine uses
        this to batch frames in period-groups with a CONCRETE FrameCount
        per group position, which keeps time-dependent spatial fields
        (e.g. ntsc-pass1's chroma-phase trig) batch-invariant under vmap
        instead of recomputing them per frame."""
        import math

        m = 1
        for cp in self.passes:
            if cp.uses_time:
                return None
            if cp.uses_frame_count:
                mod = self.preset.passes[cp.index].frame_count_mod
                if not mod or mod <= 0:
                    return None
                m = math.lcm(m, int(mod))
        return m


class PresetCompileError(Exception):
    pass


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel (8-bit depth only)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (types 0-4) of a decompressed
    IDAT stream; returns uint8 [height, stride]."""
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prior) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: left-to-right dependency
            cur_l = line.tolist()
            up = prior.tolist()
            for i in range(stride):
                a = cur_l[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur_l[i] = (cur_l[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur_l[i] = (cur_l[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.int32)
        else:
            raise PresetCompileError(f"corrupt PNG: filter type {ftype} on row {y}")
        out[y] = cur
        prior = cur
    return out


def _load_png_rgba(path: str) -> np.ndarray:
    """Decode a LUT texture PNG to float32 RGBA [H, W, 4] in [0, 1] with
    the standard library alone (zlib + struct). Handles non-interlaced
    8-bit gray, gray+alpha, RGB, RGBA and palette images (palette alpha
    from tRNS); anything else raises PresetCompileError naming what it
    found."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise PresetCompileError(f"LUT {path}: not a PNG file")
    pos, ihdr, palette, trns, idat = 8, None, None, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise PresetCompileError(f"LUT {path}: corrupt PNG chunk {ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise PresetCompileError(f"LUT {path}: PNG has no IHDR chunk")
    width, height, depth, color, _comp, _filt, interlace = ihdr
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise PresetCompileError(
            f"LUT {path}: unsupported PNG (bit depth {depth}, color type "
            f"{color}, interlace {interlace}); supported are non-interlaced "
            "8-bit gray, gray+alpha, RGB, RGBA and palette images"
        )
    ch = _PNG_CHANNELS[color]
    px = _png_unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    px = px.reshape(height, width, ch)
    if color == 3:
        if palette is None:
            raise PresetCompileError(f"LUT {path}: palette PNG has no PLTE chunk")
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            alpha[: len(trns)] = trns[: len(palette)]
        lut = np.concatenate([palette, alpha[:, None]], axis=1)
        rgba = lut[px[..., 0]]
    else:
        opaque = np.full((height, width, 1), 255, np.uint8)
        gray = px[..., :1]
        rgba = {
            0: lambda: np.concatenate([gray, gray, gray, opaque], axis=-1),
            4: lambda: np.concatenate([gray, gray, gray, px[..., 1:2]], axis=-1),
            2: lambda: np.concatenate([px, opaque], axis=-1),
            6: lambda: px,
        }[color]()
    return rgba.astype(np.float32) / 255.0


def _compat_rewrites(src: str, shader_path: str, cfg) -> str:
    """Per-shader compatibility source rewrites, mirroring the
    reference's injectCompatibilityCode (ShaderPreprocessor.cpp:527-634):

    * box-center.glsl treats gl_FragCoord as normalized in its border
      test (black screen otherwise) — normalize it;
    * interlacing.glsl in a height-scaling pass needs line-replicated
      input coords and output-based interlace parity."""
    base = Path(shader_path).name
    if base == "box-center.glsl":
        pat = "bordertest = gl_FragCoord.xy;"
        src = src.replace(
            pat, pat + "\n   bordertest = bordertest / OutputSize.xy;"
        )
    if base == "interlacing.glsl":
        scales_height = cfg.scale_type_y in ("viewport", "absolute") or (
            cfg.scale_type_y == "source" and cfg.scale_y != 1.0
        )
        if scales_height:
            src = src.replace(
                "TEX0.xy = TexCoord.xy;",
                "TEX0.xy = TexCoord.xy;\n"
                "   TEX0.y = (floor(TEX0.y * OutputSize.y / 2.0) + 0.5) / InputSize.y;",
            )
            src = re.sub(
                r"\by\s*=\s*2\.0+[0-9]*\s*\*\s*TextureSize\.y\s*\*\s*vTexCoord\.y",
                "y = 2.000001 * TextureSize.y * (gl_FragCoord.y / OutputSize.y)",
                src,
            )
            src = re.sub(
                r"\by\s*=\s*TextureSize\.y\s*\*\s*vTexCoord\.y",
                "y = TextureSize.y * (gl_FragCoord.y / OutputSize.y)",
                src,
            )
    return src


def compile_preset(preset: Preset) -> PresetProgram:
    passes: list[CompiledPass] = []
    all_params: dict[str, PragmaParameter] = {}
    for i, cfg in enumerate(preset.passes):
        path = Path(cfg.shader_path)
        if not path.is_file():
            raise PresetCompileError(f"pass {i}: shader not found: {cfg.shader_path}")
        src = path.read_text(encoding="utf-8", errors="replace")
        src = _compat_rewrites(src, str(path), cfg)
        vsrc, vparams = preprocess(src, "vertex", filename=str(path))
        fsrc, fparams = preprocess(src, "fragment", filename=str(path))
        vtu = parse(vsrc)
        ftu = parse(fsrc)
        samplers = []
        for tu in (vtu, ftu):
            for g in tu.globals():
                if g.type.name.startswith("sampler"):
                    samplers.extend(d.name for d in g.declarators)
        n_tex = len(
            re.findall(r"\b(?:texture2D|texture|texelFetch|textureLod)\s*\(", fsrc)
        )
        # Temporal-uniform USAGE (not declaration): every slang-era GLSL
        # shader declares `uniform int FrameCount;` in its boilerplate,
        # so declaration lines (and layout/struct members) must be
        # stripped before the token scan or the detector is always-true.
        both = "\n".join(
            ln
            for ln in (vsrc + "\n" + fsrc).splitlines()
            if not re.match(r"\s*(?:layout\s*\(.*\)\s*)?uniform\b", ln)
        )
        cp = CompiledPass(
            index=i,
            vertex_eval=ShaderEval(vtu, "vertex"),
            fragment_eval=ShaderEval(ftu, "fragment"),
            parameters=fparams,
            sampler_names=tuple(samplers),
            texture_calls=n_tex,
            uses_frame_count=bool(
                re.search(r"\b(?:FrameCount|FRAMEINDEX|frame_count)\b", both)
            ),
            uses_time=bool(re.search(r"\b(?:TIME|Time|frame_time)\b", both)),
        )
        passes.append(cp)
        for p in fparams:
            all_params.setdefault(p.name, p)

    luts: dict[str, LutTexture] = {}
    for name, tc in preset.textures.items():
        if not tc.path or not Path(tc.path).is_file():
            continue
        luts[name] = LutTexture(
            name=name,
            data=_load_png_rgba(tc.path),
            linear=tc.linear,
            wrap_mode=tc.wrap_mode,
            mipmap=tc.mipmap,
        )

    # Effective defaults: pragma default overridden by preset-file value
    # (custom user values layer on top at apply() time).
    defaults = {name: p.initial for name, p in all_params.items()}
    for k, v in preset.parameters.items():
        defaults[k] = v
    return PresetProgram(
        preset=preset, passes=passes, luts=luts, parameters=all_params, defaults=defaults
    )


# ---------------------------------------------------------------------------


@dataclass
class TexBinding:
    tex: Any  # [H, W, 4] array
    filter_linear: bool
    wrap_mode: str
    mipmap: bool = False
    # Texels provably on the k/255 grid (RGBA8 pass outputs, history
    # entries, u8 chain input, PNG LUTs) — see SamplerVal.quantized.
    quantized: bool = False

    def sampler(self, name: str) -> SamplerVal:
        return SamplerVal(
            name, self.tex, self.filter_linear, self.wrap_mode, self.mipmap,
            self.quantized,
        )


def _vec(vals, base="float") -> V:
    dt = np.int32 if base == "int" else np.float32
    return V(np.asarray(vals, dt), GType(base, (len(vals),)))


def _size_vec4(w: float, h: float) -> np.ndarray:
    return np.array(
        [w, h, 1.0 / w if w else 0.0, 1.0 / h if h else 0.0], np.float32
    )


class PassContext:
    """Uniform/sampler resolution context for one pass execution."""

    def __init__(
        self,
        program: PresetProgram,
        pass_index: int,
        *,
        shapes: list[PassShapes],
        viewport: tuple[int, int],
        source_size: tuple[int, int],
        input_binding: TexBinding,
        original_binding: TexBinding,
        pass_outputs: list[Optional[TexBinding]],
        history: list[TexBinding],
        feedback: dict[int, TexBinding],
        frame_count,
        frame_time,
        params: dict[str, Any],
        lut_data: "Optional[dict[str, Any]]" = None,
    ):
        self.program = program
        self.i = pass_index
        self.shapes = shapes
        self.viewport = viewport
        self.source_size = source_size
        self.input_binding = input_binding
        self.original_binding = original_binding
        self.pass_outputs = pass_outputs
        self.history = history
        self.feedback = feedback
        self.frame_count = frame_count
        self.frame_time = frame_time
        self.params = params
        # Device-resident LUT arrays threaded as jit ARGUMENTS by the
        # engine (None → fall back to embedding lut.data as a trace
        # constant, fine for the CPU oracle/tools). Embedded constants
        # become StableHLO literals: iq-canyon's four 1024x1024 LUTs
        # inflated its program to 102 MB of HLO and a multi-gigabyte
        # serialized executable.
        self.lut_data = lut_data
        sh = shapes[pass_index]
        self.in_size = (sh.in_w, sh.in_h)
        self.out_size = (sh.out_w, sh.out_h)
        # Active phase-factored grid (graph/factored.Factorization) or
        # None: set per evaluation attempt by runtime/engine._run_pass.
        self.factored = None
        self._alias_to_pass = {
            cfg.alias: j
            for j, cfg in enumerate(program.preset.passes)
            if cfg.alias
        }

    # -- samplers -------------------------------------------------------
    def resolve_sampler(self, name: str) -> Optional[SamplerVal]:
        b = self._resolve_binding(name)
        return b.sampler(name) if b is not None else None

    def _output_binding(self, j: int) -> Optional[TexBinding]:
        if 0 <= j < len(self.pass_outputs):
            return self.pass_outputs[j]
        return None

    def _resolve_binding(self, name: str) -> Optional[TexBinding]:
        prog, i = self.program, self.i
        if name in prog.luts:
            lut = prog.luts[name]
            import jax.numpy as jnp

            data = None if self.lut_data is None else self.lut_data.get(name)
            if data is None:
                data = jnp.asarray(lut.data)
            return TexBinding(
                data, lut.linear, lut.wrap_mode, lut.mipmap,
                quantized=True,  # PNG bytes / 255 (see _load_lut)
            )
        if name in self._alias_to_pass:
            j = self._alias_to_pass[name]
            if j < i:
                b = self._output_binding(j)
                if b is not None:
                    return b
        if name in _INPUT_SAMPLER_NAMES:
            return self.input_binding
        if name == "OrigTexture":
            return self.original_binding
        m = _FEEDBACK_RE.match(name)
        if m:
            j = int(m.group(1))
            fb = self.feedback.get(j)
            return fb if fb is not None else self._output_binding(j) or self.input_binding
        if i == 0:
            m = _PREVK_TEX_RE.match(name)
            if m:
                k = int(m.group(1)) if m.group(1) else 0
                return self._history_or_input(k)
            m = _PASSPREV_TEX_RE.match(name)
            if m:
                # At pass 0 the reference pairs PassPrevNTexture with
                # PrevNTexture — both bind history[N]
                # (ShaderEngine.cpp:1100-1125).
                return self._history_or_input(int(m.group(1)))
        else:
            m = _PASSPREV_TEX_RE.match(name)
            if m:
                n = int(m.group(1))
                if n <= i:
                    b = self._output_binding(i - n)
                    if b is not None:
                        return b
                return self.original_binding  # kawase_glow pattern
            m = _PREVK_TEX_RE.match(name)
            if m:
                k = int(m.group(1)) if m.group(1) else 0
                b = self._output_binding(k)
                if b is not None:
                    return b
        # Unbound sampler → texture unit 0 → the pass input.
        return self.input_binding

    def _history_or_input(self, k: int) -> TexBinding:
        if 0 <= k < len(self.history):
            return self.history[k]
        return self.input_binding

    # -- uniforms -------------------------------------------------------
    def resolve_uniform(self, name: str, gtype: GType) -> Optional[V]:
        iw, ih = self.in_size
        ow, oh = self.out_size
        sw, sh = self.source_size

        def sized(w, h):
            full = _size_vec4(w, h)
            if gtype.is_scalar:
                return V(np.float32(full[0]), FLOAT)
            n = gtype.shape[0] if gtype.is_vector else 4
            return _vec(full[:n])

        if name in ("SourceSize",):
            return sized(iw, ih)
        if name in ("OriginalSize", "TexSize0"):
            return sized(sw, sh)
        if name in ("OutputSize", "OutSize", "outsize"):
            return sized(ow, oh)
        if name == "TextureSize":
            return sized(iw, ih)
        if name == "InputSize":
            return sized(iw, ih)
        m = _PASSPREV_SIZE_RE.match(name)
        if m and self.i > 0:
            n = int(m.group(1))
            kind = m.group(2)
            j = self.i - n
            if 0 <= j < len(self.shapes):
                t = self.shapes[j]
                if kind == "InputSize":
                    return sized(t.in_w, t.in_h)
                return sized(t.out_w, t.out_h)
            return sized(sw, sh)
        m = _PASS_SIZE_RE.match(name)
        if m:
            j = int(m.group(2))
            if 0 <= j < len(self.shapes):
                t = self.shapes[j]
                if m.group(1) == "Output":
                    return sized(t.out_w, t.out_h)
                return sized(t.in_w, t.in_h)
        m = _HISTORY_SIZE_RE.match(name)
        if m:
            k = int(m.group(1))
            if k == 0 or not (0 < k <= len(self.history)):
                return sized(sw, sh)
            b = self.history[k - 1]
            return sized(b.tex.shape[1], b.tex.shape[0])
        if name in self._alias_to_pass and gtype.is_vector:
            # vec4 <Alias>Size
            j = self._alias_to_pass[name]
            t = self.shapes[j]
            return sized(t.out_w, t.out_h)
        if name.endswith("Size") and name[:-4] in self._alias_to_pass:
            j = self._alias_to_pass[name[:-4]]
            t = self.shapes[j]
            return sized(t.out_w, t.out_h)
        # Alias-prefixed cg-style size uniforms (crt-royale declares e.g.
        # `uniform vec2 HALATION_BLURtexture_size;` — RetroArch sets these;
        # the reference leaves them 0, black-screening royale chains).
        for suffix, kind in (
            ("texture_size", "out"),
            ("output_size", "out"),
            ("video_size", "in"),
        ):
            if name.endswith(suffix) and name[: -len(suffix)] in self._alias_to_pass:
                j = self._alias_to_pass[name[: -len(suffix)]]
                t = self.shapes[j]
                if kind == "out":
                    return sized(t.out_w, t.out_h)
                return sized(t.in_w, t.in_h)
        if name.endswith("Size") and name[:-4] in self.program.luts:
            lut = self.program.luts[name[:-4]]
            return sized(lut.data.shape[1], lut.data.shape[0])
        if name in ("FrameCount", "FRAMEINDEX"):
            fc = self.frame_count
            mod = self.program.preset.passes[self.i].frame_count_mod
            if mod and mod > 0:
                fc = fc % mod
            if gtype.base == "float":
                return V(fc.astype(np.float32) if hasattr(fc, "astype") else np.float32(fc), FLOAT)
            return V(fc, INT)
        if name == "FrameDirection":
            return V(np.int32(1) if gtype.base != "float" else np.float32(1.0), GType(gtype.base, ()))
        if name in ("TIME", "Time"):
            return V(self.frame_time, FLOAT)
        if name == "MVPMatrix":
            return V(np.eye(4, dtype=np.float32), GType("float", (4, 4)))
        if name == "internal_res":
            return V(np.float32(1.0), FLOAT)
        if name == "auto_res":
            return V(np.float32(0.0), FLOAT)
        if name in self.params:
            return V(self.params[name], FLOAT)
        if name in LEGACY_PARAM_DEFAULTS:
            return V(np.float32(LEGACY_PARAM_DEFAULTS[name]), FLOAT)
        return None

    def resolve_struct_uniform(self, name: str, fields: list) -> Optional[StructVal]:
        iw, ih = self.in_size
        ow, oh = self.out_size
        sw, sh = self.source_size
        out: dict[str, Any] = {}
        for ftype, fname, _ in fields:
            if fname == "video_size":
                out[fname] = _vec([sw, sh])
            elif fname == "texture_size":
                out[fname] = _vec([iw, ih])
            elif fname == "output_size":
                out[fname] = _vec([ow, oh])
            elif fname == "frame_count":
                fc = self.frame_count
                out[fname] = V(fc, INT) if ftype.name == "int" else V(
                    fc.astype(np.float32) if hasattr(fc, "astype") else np.float32(fc),
                    FLOAT,
                )
            elif fname == "frame_direction":
                out[fname] = V(np.float32(1.0), FLOAT)
            else:
                out[fname] = V(np.float32(0.0), FLOAT)
        return StructVal(name, out)
