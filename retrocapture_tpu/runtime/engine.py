"""The Engine — RetroCapture's ShaderEngine contract as a JAX program.

API mirrors src/shader/ShaderEngine.h:54-93: ``load_preset`` /
``set_parameter`` / ``get_parameters`` / ``apply``; a failed preset load
degrades to passthrough while keeping extracted parameter metadata for
UIs, exactly like the reference (ShaderEngine.cpp:294-314).

Execution model (an array program, not a port):
* The whole multi-pass chain for one (source, viewport) shape pair is
  traced once into a single XLA program — per-pass FBOs become
  intermediate tensors XLA keeps in device memory, and the per-pass
  "framebuffer format" (RGBA8 quantize / sRGB round-trip / float) is a
  fused epilogue (ops/colorspace.framebuffer_store).
* Runtime parameters are trace-time constants by default: coordinate
  math that depends only on uniforms folds to NumPy during tracing and
  never reaches the device. Changing a parameter invalidates the jit
  cache (a recompile), the idiomatic JAX trade for maximum steady-state
  throughput; FrameCount/Time stay traced so animation never retraces.
* Temporal state (7-deep history ring of final outputs —
  ShaderEngine.cpp:1731-1865 — and PassFeedback ping-pong :1280-1347)
  is an explicit pytree carried through ``lax.scan`` for batched
  streams; stateless presets batch via ``vmap`` instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import os

import jax
import jax.numpy as jnp
import numpy as np

from retrocapture_tpu.frontend.interp import UnsupportedShaderError
from retrocapture_tpu.frontend.values import GlslEvalError
from retrocapture_tpu.frontend.values import GType, V
from retrocapture_tpu.graph.plan import (
    PassContext,
    PresetProgram,
    TexBinding,
    compile_preset,
)
from retrocapture_tpu.graph.scale import PassShapes, compute_chain_shapes
from retrocapture_tpu.ops.colorspace import framebuffer_store
from retrocapture_tpu.ops.sampling import resize_linear, sample2d
from retrocapture_tpu.presets.glslp import Preset
from retrocapture_tpu.utils.logging import get_logger

__all__ = ["Engine", "MAX_FRAME_HISTORY"]

MAX_FRAME_HISTORY = 7  # ShaderEngine.h:143

log = get_logger(__name__)


def _grids(w: int, h: int) -> tuple[np.ndarray, np.ndarray]:
    """Concrete (NumPy) pixel-center coordinate grids [h, w]."""
    u = (np.arange(w, dtype=np.float32) + 0.5) / np.float32(w)
    v = (np.arange(h, dtype=np.float32) + 0.5) / np.float32(h)
    return np.broadcast_to(u[None, :], (h, w)), np.broadcast_to(v[:, None], (h, w))


def _vec4_grid(a, b, c, d, h, w) -> V:
    comps = [np.broadcast_to(np.asarray(x, np.float32), (h, w)) for x in (a, b, c, d)]
    return V(np.stack(comps, axis=-1), GType("float", (4,)))


@dataclass
class _ChainState:
    """Per-(source,viewport) device state."""

    history: tuple  # tuple of [vh, vw, 4] arrays, most recent first
    feedback: dict[int, Any]  # pass index → [oh, ow, 4]
    frame_count: Any  # int32 scalar
    time: Any  # float32 scalar


class Engine:
    """load preset → set parameters → process frames."""

    def __init__(
        self,
        viewport: Optional[tuple[int, int]] = None,
        *,
        mesh=None,
        spatial: bool = False,
    ):
        self._program: Optional[PresetProgram] = None
        self._preset: Optional[Preset] = None
        self._custom_params: dict[str, float] = {}
        self._viewport = viewport  # (W, H) or None → source size
        self._jit_cache: dict = {}
        self._states: dict = {}
        # Host-side mirror of each state's frame_count (advances
        # deterministically by the batch size per apply), so the
        # fc-period group path can know frame_count % m at TRACE time
        # without a device readback (which would stall the dispatch
        # queue once per call).
        self._fc_hosts: dict = {}
        self._mesh = mesh  # jax.sharding.Mesh: batch over 'data' axis
        self._spatial = spatial  # additionally shard W over 'space'
        self._max_resolution: Optional[tuple[int, int]] = None
        self._param_mode = "const"  # "const" | "traced"
        self._param_const_fallback = False  # traced lowering failed once
        self._input_format = "rgb"  # rgb | nv12 | yuyv | uyvy
        self._lowering_failed = False
        self._lut_dev_cache = None  # (program, device LUT tuple)
        self.shader_active = False
        self.last_error: Optional[str] = None

    # -- preset management ---------------------------------------------
    def load_preset(self, path: str) -> bool:
        """Parse + compile a .glslp (or bare .glsl as a single pass).
        Returns False and degrades to passthrough on failure, keeping any
        extracted parameters (reference behavior, ShaderEngine.cpp:294)."""
        self._jit_cache.clear()
        self._states.clear()
        self._fc_hosts.clear()
        self._custom_params.clear()
        self._lowering_failed = False
        self._param_const_fallback = False
        self._lut_dev_cache = None
        try:
            if str(path).endswith(".glsl"):
                preset = Preset.loads(f"shaders = 1\nshader0 = {path}\n", path=str(path))
            else:
                preset = Preset.load(path)
            self._preset = preset
            self._program = compile_preset(preset)
            self.shader_active = True
            self.last_error = None
            return True
        except Exception as e:  # noqa: BLE001 - degrade like the reference
            log.warning("preset load failed, falling back to passthrough: %s", e)
            self.last_error = f"{type(e).__name__}: {e}"
            self._program = None
            self.shader_active = False
            return False

    def unload(self) -> None:
        self._program = None
        self._preset = None
        self._lut_dev_cache = None
        self.shader_active = False
        self._jit_cache.clear()
        self._states.clear()
        self._fc_hosts.clear()

    # -- parameters -----------------------------------------------------
    def get_parameters(self) -> list[dict]:
        """Dedup'd parameter metadata across passes, first-wins; value
        precedence custom > preset-file > pragma default
        (ShaderEngine::getShaderParameters, ShaderEngine.cpp:3264)."""
        if self._program is None:
            return []
        out = []
        for name, meta in self._program.parameters.items():
            value = self._custom_params.get(name, self._program.defaults.get(name, meta.initial))
            out.append(
                {
                    "name": name,
                    "description": meta.description,
                    "value": float(value),
                    "default": meta.initial,
                    "min": meta.minimum,
                    "max": meta.maximum,
                    "step": meta.step,
                }
            )
        return out

    def set_parameter(self, name: str, value: float) -> bool:
        """Validates the parameter exists and clamps to [min, max]
        (ShaderEngine::setShaderParameter, ShaderEngine.cpp:3353)."""
        if self._program is None or name not in self._program.parameters:
            return False
        meta = self._program.parameters[name]
        value = float(np.clip(value, meta.minimum, meta.maximum))
        self._custom_params[name] = value
        if self._effective_param_mode() == "const":
            self._jit_cache.clear()  # params are trace-time constants
        return True

    def set_param_mode(self, mode: str) -> None:
        """'const' (default): parameters fold at trace time for maximum
        steady-state throughput; changing one recompiles. 'traced':
        parameters are device scalars fed per call — set_parameter applies
        on the next frame with zero recompiles, matching the reference's
        glUniform semantics (ShaderEngine.cpp:3353, :2216-2256).
        Parameter-dependent sampling grids then take the traced-warp
        paths instead of const-folding; if a shader needs a parameter to
        be concrete (loop bound, array size), the engine falls back to
        const mode for that preset automatically."""
        assert mode in ("const", "traced"), mode
        if mode != self._param_mode:
            self._param_mode = mode
            self._jit_cache.clear()

    def _effective_param_mode(self) -> str:
        if self._param_mode == "traced" and not self._param_const_fallback:
            return "traced"
        return "const"

    def _param_values(self) -> dict:
        params = dict(self._program.defaults)
        params.update(self._custom_params)
        return {k: jnp.float32(v) for k, v in params.items()}

    def get_parameter(self, name: str) -> Optional[float]:
        if self._program is None:
            return None
        if name in self._custom_params:
            return self._custom_params[name]
        return self._program.defaults.get(name)

    def set_input_format(self, fmt: str) -> None:
        """Raw capture pixel format: 'rgb' (default, [H,W,3] u8/float),
        'nv12' (packed planes [H*3/2, W] u8), 'yuyv'/'uyvy' ([H, W*2]
        u8). Non-RGB formats are converted to RGB *inside* the chain's
        jit — one XLA program does convert → chain → blit, the fused
        replacement for FrameProcessor + sws_scale
        (processing/FrameProcessor.cpp:149-179, SURVEY.md §7 step 6)."""
        assert fmt in ("rgb", "nv12", "yuyv", "uyvy"), fmt
        if fmt != self._input_format:
            self._input_format = fmt
            self._jit_cache.clear()

    def _packed_hw(self, ph: int, pw: int) -> tuple[int, int]:
        """Logical (h, w) from a packed raw plane shape."""
        fmt = self._input_format
        if fmt == "nv12":
            return (ph * 2) // 3, pw
        if fmt in ("yuyv", "uyvy"):
            return ph, pw // 2
        return ph, pw

    def _convert_packed(self, raw_b):
        """Packed u8 batch → float RGB [B, H, W, 3] (traceable)."""
        from retrocapture_tpu.ops import colorspace as cs

        fmt = self._input_format
        ph, pw = raw_b.shape[1], raw_b.shape[2]
        h, w = self._packed_hw(ph, pw)
        if fmt == "nv12":
            y = raw_b[:, :h, :]
            uv = raw_b[:, h:, :]
            return cs.nv12_to_rgb(y, uv, w, h)
        if fmt == "yuyv":
            return cs.yuyv_to_rgb(raw_b, w, h)
        if fmt == "uyvy":
            return cs.uyvy_to_rgb(raw_b, w, h)
        return raw_b

    def set_viewport(self, width: int, height: int) -> None:
        self._viewport = (int(width), int(height))
        self._jit_cache.clear()

    def set_max_shader_resolution(self, width: int, height: int) -> None:
        """Clamp the chain's source resolution: larger inputs are
        downscaled (bilinear) before the first pass — the low-power-device
        path (ShaderEngine::setMaxShaderResolution, ShaderEngine.cpp:50-63,
        applied at :1621-1657). 0 disables."""
        self._max_resolution = (int(width), int(height))
        self._jit_cache.clear()
        self._states.clear()
        self._fc_hosts.clear()

    def reset_state(self) -> None:
        self._states.clear()
        self._fc_hosts.clear()

    # -- state checkpoint/restore ----------------------------------------
    def save_state(self, path: str) -> None:
        """Serialize temporal state (history ring, PassFeedback textures,
        frame counters) to an .npz — mid-stream resume for temporal
        presets, a capability the reference lacks (its persistence is
        config-only, SURVEY.md §5)."""
        blobs: dict[str, np.ndarray] = {}
        meta = []
        for ki, (key, st) in enumerate(self._states.items()):
            meta.append(
                {
                    "key": list(key),
                    "n_history": len(st.history),
                    "feedback_keys": sorted(st.feedback),
                }
            )
            for j, htex in enumerate(st.history):
                blobs[f"s{ki}_h{j}"] = np.asarray(htex)
            for j in sorted(st.feedback):
                blobs[f"s{ki}_f{j}"] = np.asarray(st.feedback[j])
            blobs[f"s{ki}_fc"] = np.asarray(st.frame_count)
            blobs[f"s{ki}_tm"] = np.asarray(st.time)
        import json as _json

        blobs["__meta__"] = np.frombuffer(
            _json.dumps(meta).encode(), dtype=np.uint8
        )
        np.savez(_npz_path(path), **blobs)

    def load_state(self, path: str) -> None:
        import json as _json

        data = np.load(_npz_path(path))
        meta = _json.loads(bytes(data["__meta__"]).decode())
        self._states.clear()
        self._fc_hosts.clear()
        for ki, m in enumerate(meta):
            history = tuple(
                jnp.asarray(data[f"s{ki}_h{j}"]) for j in range(m["n_history"])
            )
            feedback = {
                j: jnp.asarray(data[f"s{ki}_f{j}"]) for j in m["feedback_keys"]
            }
            st = _ChainState(
                history=history,
                feedback=feedback,
                frame_count=jnp.asarray(data[f"s{ki}_fc"]),
                time=jnp.asarray(data[f"s{ki}_tm"]),
            )
            self._states[tuple(m["key"])] = st
            self._fc_hosts[tuple(m["key"])] = int(data[f"s{ki}_fc"])

    # -- application ----------------------------------------------------
    def apply(self, frames, output: str = "f32") -> jax.Array:
        """Process one frame [H,W,3|4] or a batch [B,H,W,3|4] (uint8 or
        float). Returns RGB at the viewport size: float32 in [0,1]
        (default) or, with ``output="u8"``, uint8 ON DEVICE — the
        viewport blit fuses resample+quantize and the result
        moves 1/4 of the bytes, matching the reference's RGBA8 FBO
        product + PBO readback (PBOManager.cpp:86-170). Batches of
        temporal presets run as a sequential scan; stateless presets
        vmap."""
        assert output in ("f32", "u8"), output
        arr = jnp.asarray(frames)
        packed = self._input_format != "rgb"
        if not packed and arr.ndim == 5:
            return self.apply_streams(arr)
        batched = arr.ndim == (3 if packed else 4)
        if not batched:
            arr = arr[None]
        if packed:
            h, w = self._packed_hw(arr.shape[1], arr.shape[2])
        else:
            h, w = arr.shape[1], arr.shape[2]
        vw, vh = self._viewport or (w, h)

        if self._program is None or self._lowering_failed:
            src = self._to_rgba_float(
                self._convert_packed(arr) if packed else arr
            )
            out = self._passthrough(src, vw, vh)[..., :3]
            if output == "u8":
                out = _quantize_u8(out)
            return out if batched else out[0]

        # Input normalization (u8→float, RGB→RGBA) happens INSIDE the jit
        # — eager ops per call are expensive on remote backends.
        key = (h, w, vw, vh)
        try:
            state = self._get_state(
                key, jnp.float32, seed_source=self._history_seed(key, arr, packed)
            )
            fc_static = (
                int(np.asarray(state.frame_count)) if _CONCRETE_FC else None
            )
            temporal = self._program.uses_history() or self._program.uses_feedback()
            # fc-period batch grouping (graph.plan.fc_period): when the
            # chain depends on FrameCount only through FrameCount % m,
            # frames are processed in period-groups with a CONCRETE fc
            # per group position, so fc-dependent spatial fields (e.g.
            # ntsc chroma-phase trig) stay batch-invariant under vmap.
            fc_group = None
            nb_in = arr.shape[0]
            if (
                _FC_GROUP
                and fc_static is None
                and not temporal
                and self._mesh is None
                and nb_in > 1
            ):
                m = self._program.fc_period()
                r0 = self._fc_hosts.get(key)
                # m == 1 means the chain is fc-free: grouping would add
                # interleave copies (and a fresh program identity) for
                # zero benefit, so only periods >= 2 group.
                if m is not None and 2 <= m <= 8 and nb_in % m == 0 and r0 is not None:
                    fc_group = (m, r0 % m)
            fn = self._get_jit(
                key, u8=output == "u8", fc_static=fc_static, fc_group=fc_group
            )
            if self._mesh is not None and not temporal:
                from retrocapture_tpu.parallel.mesh import shard_frames

                arr = shard_frames(arr, self._mesh, spatial=self._spatial)
            if self._effective_param_mode() == "traced":
                out, new_state = fn(arr, state, self._param_values())
            else:
                out, new_state = fn(arr, state)
        except (GlslEvalError, ValueError, IndexError, TypeError) as e:
            if self._effective_param_mode() == "traced":
                # The shader needs a concrete parameter (loop bound,
                # array size, const-folded grid) — retry in const mode.
                log.warning("traced params unsupported here, const fallback: %s", e)
                self._param_const_fallback = True
                self._jit_cache.clear()
                return self.apply(frames, output=output)
            # A pass failed to lower — the reference's GL compile would
            # have failed too; degrade to passthrough but KEEP the
            # extracted parameter metadata (ShaderEngine.cpp:294-314).
            log.warning("shader lowering failed, passthrough: %s", e)
            self.last_error = f"{type(e).__name__}: {e}"
            self.shader_active = False
            self._lowering_failed = True
            self._jit_cache.clear()
            self._states.clear()
            self._fc_hosts.clear()
            src = self._to_rgba_float(arr)
            out = self._passthrough(src, vw, vh)[..., :3]
            if output == "u8":
                out = _quantize_u8(out)
            return out if batched else out[0]
        self._states[key] = new_state
        self._fc_hosts[key] = self._fc_hosts.get(key, 0) + nb_in
        return out if batched else out[0]

    def apply_streams(self, frames) -> jax.Array:
        """Process S independent streams of T frames each:
        ``[S, T, H, W, 3|4]`` → ``[S, T, vh, vw, 3]``. Temporal state is
        kept per stream (vmap over streams, lax.scan over time) — the
        scaling path for PassFeedback/history presets, whose frames are
        strictly sequential within one stream but embarrassingly parallel
        across streams (and across the 'data' mesh axis)."""
        arr = jnp.asarray(frames)
        assert arr.ndim == 5, "apply_streams expects [S, T, H, W, C]"
        s, t, h, w = arr.shape[0], arr.shape[1], arr.shape[2], arr.shape[3]
        vw, vh = self._viewport or (w, h)
        if self._program is None or self._lowering_failed:
            src = self._to_rgba_float(arr)
            flat = src.reshape((s * t,) + src.shape[2:])
            out = self._passthrough(flat, vw, vh)[..., :3]
            return out.reshape((s, t) + out.shape[1:])
        src = arr  # normalization happens inside the inner jit

        key = (h, w, vw, vh, s, self._effective_param_mode())
        state = self._states.get(key)
        if state is None:
            proto = self._get_state((h, w, vw, vh), jnp.float32)
            state = jax.tree.map(
                lambda x: jnp.broadcast_to(x, (s,) + jnp.shape(x)), proto
            )
            if self._program.uses_history() and state.history:
                # Seed each stream's cold ring from its own first frame
                # (unfilled-slot = pass-input reference semantics).
                hh, hw = state.history[0].shape[1:3]
                firsts = jax.vmap(self._to_rgba_float)(src[:, 0])
                entry = jax.vmap(lambda f: _history_entry(f, hw, hh))(firsts)
                state = _ChainState(
                    history=tuple(entry for _ in state.history),
                    feedback=state.feedback,
                    frame_count=state.frame_count,
                    time=state.time,
                )
            self._states[key] = state
        traced = self._effective_param_mode() == "traced"
        fn = self._jit_cache.get(key)
        if fn is None:
            inner = self._get_jit((h, w, vw, vh))

            if traced:

                def multi(src_st, st, pvals):
                    return jax.vmap(inner, in_axes=(0, 0, None))(src_st, st, pvals)

            else:

                def multi(src_st, st):
                    return jax.vmap(inner)(src_st, st)

            if self._mesh is not None:
                # Streams shard over 'data'; per-stream temporal state
                # shards with them (leading axis is the stream axis).
                from jax.sharding import NamedSharding, PartitionSpec as P

                from retrocapture_tpu.parallel.mesh import DATA_AXIS

                def sh(rank):
                    return NamedSharding(
                        self._mesh, P(DATA_AXIS, *([None] * (rank - 1)))
                    )

                src_sh = sh(5)
                state_sh = jax.tree.map(lambda x: sh(max(jnp.ndim(x), 1)), state)
                out_sh = (sh(5), state_sh)
                fn = jax.jit(multi, in_shardings=(src_sh, state_sh), out_shardings=out_sh)
            else:
                fn = jax.jit(multi)
            self._jit_cache[key] = fn
        try:
            if traced:
                out, new_state = fn(src, state, self._param_values())
            else:
                out, new_state = fn(src, state)
        except (GlslEvalError, ValueError, IndexError, TypeError) as e:
            if traced:
                log.warning("traced params unsupported here, const fallback: %s", e)
                self._param_const_fallback = True
                self._jit_cache.clear()
                return self.apply_streams(arr)
            # Same degrade-to-passthrough path as apply()
            # (ShaderEngine.cpp:294-314).
            log.warning("shader lowering failed, passthrough: %s", e)
            self.last_error = f"{type(e).__name__}: {e}"
            self.shader_active = False
            self._lowering_failed = True
            self._jit_cache.clear()
            self._states.clear()
            self._fc_hosts.clear()
            return self.apply_streams(arr)
        self._states[key] = new_state
        return out[..., :3]

    # convenience mirrors of the reference's RGB24 readback output
    def apply_u8(self, frames) -> np.ndarray:
        """Like apply() but the final blit fuses resample+quantize and
        returns uint8 — the host transfer moves
        1/4 of the bytes (the PBO-readback analog)."""
        arr = jnp.asarray(frames)
        batched = arr.ndim == 4
        if (
            self._program is None
            or self._lowering_failed
            or arr.ndim not in (3, 4)
        ):
            return np.asarray(_quantize_u8(self.apply(frames)))
        if not batched:
            arr = arr[None]
        h, w = arr.shape[1], arr.shape[2]
        vw, vh = self._viewport or (w, h)
        key = (h, w, vw, vh)
        try:
            state = self._get_state(
                key, jnp.float32, seed_source=self._history_seed(key, arr, False)
            )
            fn = self._get_jit(key, u8=True)
            if self._effective_param_mode() == "traced":
                out, new_state = fn(arr, state, self._param_values())
            else:
                out, new_state = fn(arr, state)
        except (GlslEvalError, ValueError, IndexError, TypeError, NotImplementedError):
            return np.asarray(_quantize_u8(self.apply(frames)))
        self._states[key] = new_state
        out = np.asarray(out)
        return out if batched else out[0]

    # -- internals ------------------------------------------------------
    def _history_seed(self, key, arr, packed: bool):
        """Normalized first frame for seeding a cold history ring, or
        None when the state is already warm / the preset keeps none."""
        if key in self._states or not self._program.uses_history():
            return None
        first = self._convert_packed(arr[:1]) if packed else arr[:1]
        return self._to_rgba_float(first)[0]

    @staticmethod
    def _to_rgba_float(arr) -> jax.Array:
        if arr.dtype == jnp.uint8:
            arr = arr.astype(jnp.float32) * (1.0 / 255.0)
        else:
            arr = arr.astype(jnp.float32)
        if arr.shape[-1] == 3:
            alpha = jnp.ones(arr.shape[:-1] + (1,), jnp.float32)
            arr = jnp.concatenate([arr, alpha], axis=-1)
        return arr

    @staticmethod
    def _resize_bilinear(tex, out_w: int, out_h: int):
        u, v = _grids(out_w, out_h)
        return sample2d(tex, u, v, filter_linear=True)

    def _passthrough(self, src, vw: int, vh: int):
        if src.shape[2] == vw and src.shape[1] == vh:
            return src
        return jax.vmap(lambda t: self._resize_bilinear(t, vw, vh))(src)

    def _get_state(self, key, dtype, seed_source=None) -> _ChainState:
        st = self._states.get(key)
        if st is not None:
            return st
        h, w, vw, vh = key
        prog = self._program
        pw, ph = self._clamped_source(w, h)
        shapes = compute_chain_shapes(
            prog.preset, pw, ph, vw, vh, max_resolution=self._max_resolution
        )
        history = ()
        if prog.uses_history():
            last = shapes[-1]
            if seed_source is not None:
                # Reference semantics for unfilled history slots: the
                # PrevN sampler stays unbound → texture unit 0 → the
                # pass input (ShaderEngine.cpp:1137-1155, deliberately
                # avoiding the darkening a black frame would cause).
                # Static shapes can't alias the input texture per slot,
                # so seed the ring with the first frame resized through
                # the same path a real history entry takes.
                entry = _history_entry(
                    jnp.asarray(seed_source), last.out_w, last.out_h
                )
                history = tuple(entry for _ in range(MAX_FRAME_HISTORY))
            else:
                history = tuple(
                    jnp.zeros((last.out_h, last.out_w, 4), jnp.float32)
                    for _ in range(MAX_FRAME_HISTORY)
                )
        feedback = {}
        if prog.uses_feedback():
            for j, sh in enumerate(shapes):
                feedback[j] = jnp.zeros((sh.out_h, sh.out_w, 4), jnp.float32)
        st = _ChainState(
            history=history,
            feedback=feedback,
            frame_count=jnp.int32(0),
            time=jnp.float32(0.0),
        )
        self._states[key] = st
        self._fc_hosts[key] = 0
        return st

    def _clamped_source(self, w: int, h: int) -> tuple[int, int]:
        """Max-resolution clamp preserving aspect, even dims
        (ShaderEngine.cpp:1621-1657)."""
        if self._max_resolution is None:
            return w, h
        mw, mh = self._max_resolution
        if mw <= 0 or mh <= 0 or (w <= mw and h <= mh):
            return w, h
        aspect = w / h
        pw, ph = w, h
        if pw > mw:
            pw = mw
            ph = int(round(mw / aspect))
        if ph > mh:
            ph = mh
            pw = int(round(mh * aspect))
        return max((pw // 2) * 2, 2), max((ph // 2) * 2, 2)

    def _get_jit(self, key, u8: bool = False, fc_static=None, fc_group=None):
        cache_key = (key, u8, self._effective_param_mode(), fc_static, fc_group)
        fn = self._jit_cache.get(cache_key)
        if fn is not None:
            return fn
        h, w, vw, vh = key
        prog = self._program
        pw, ph = self._clamped_source(w, h)
        shapes = compute_chain_shapes(
            prog.preset, pw, ph, vw, vh, max_resolution=self._max_resolution
        )
        traced_params = self._effective_param_mode() == "traced"
        params = dict(prog.defaults)
        params.update(self._custom_params)
        temporal = prog.uses_history() or prog.uses_feedback()
        # LUT textures enter the jit as ARGUMENTS, not closure constants:
        # a closed-over array becomes a StableHLO literal, and iq-canyon's
        # four 1024x1024 RGBA LUTs inflated its program to 102 MB of HLO
        # and a multi-gigabyte serialized executable.
        # The traced LUT dict and the source-quantized flag are threaded
        # explicitly through normalize/single (no shared mutable cells:
        # two threads retracing the same jitted fn concurrently must not
        # leak one trace's tracers into the other — r3 advisor finding).
        lut_names = sorted(prog.luts) if prog.luts else []

        def finalize(outs_b):
            """Batched viewport blit + output packing: an exact f32
            two-tap lerp per non-identity axis (ops/sampling.resize_linear)
            with the u8 quantize fused behind it, so the u8 path writes
            1/4 of the output bytes."""
            outs_b = resize_linear(outs_b, vw, vh)
            if not u8:
                return outs_b
            return jnp.round(jnp.clip(outs_b, 0.0, 1.0) * 255.0).astype(jnp.uint8)

        def single(
            src, history, feedback, frame_count, time, pvals=None, blit=True,
            allow_factored=True, src_quant=False, lut_data=None,
        ):
            return _run_chain(
                prog,
                shapes,
                (vw, vh),
                src,
                history,
                feedback,
                frame_count,
                time,
                pvals if pvals is not None else params,
                blit=blit,
                allow_factored=allow_factored,
                source_quantized=src_quant,
                lut_data=lut_data,
            )

        def normalize(raw_b):
            # Chain input sits on the k/255 grid only when it is raw u8
            # RGB with no packed-format convert and no pre-resize (both
            # produce off-grid floats). Trace-time static per jit key;
            # returned alongside the tensor so callers thread it into
            # single() instead of reading a shared cell.
            src_quant = (
                raw_b.dtype == jnp.uint8
                and self._input_format == "rgb"
                and (pw, ph) == (w, h)
            )
            if self._input_format != "rgb":
                raw_b = self._convert_packed(raw_b)
            src_b = Engine._to_rgba_float(raw_b)
            if (pw, ph) != (w, h):
                u, v = _grids(pw, ph)
                src_b = jax.vmap(
                    lambda t: sample2d(t, u, v, filter_linear=True)
                )(src_b)
            return src_b, src_quant

        if fc_static is not None:
            # Concrete-FrameCount mode (RCTPU_CONCRETE_FC=1, used by the
            # GL-parity harnesses): frames run unrolled with FrameCount
            # and Time as trace-time constants, so time-dependent math
            # (noise seeds `xy * float(FrameCount)`, scanline phase)
            # folds through the exact numpy path — matching the
            # reference, where every uniform is concrete per draw call.
            # Costs one retrace per frame_count value; never the default.

            def batch_fn(raw_b, state: _ChainState, pvals=None, lut_vals=None):
                src_b, sq = normalize(raw_b)
                lut = dict(zip(lut_names, lut_vals)) if lut_vals is not None else None
                nb = src_b.shape[0]
                hist, fb = state.history, state.feedback
                outs = []
                for i in range(nb):
                    out, hist, fb = single(
                        src_b[i],
                        hist,
                        fb,
                        np.int32(fc_static + i),
                        np.float32(0.016) * np.float32(fc_static + i),
                        pvals,
                        blit=False,
                        allow_factored=not temporal,
                        src_quant=sq,
                        lut_data=lut,
                    )
                    outs.append(out)
                outs = finalize(jnp.stack(outs)[..., :3])
                return outs, _ChainState(
                    hist,
                    fb,
                    state.frame_count + nb,
                    state.time + jnp.float32(0.016) * nb,
                )

        elif fc_group is not None:
            # fc-period grouped batch (graph.plan.fc_period): the chain
            # depends on FrameCount only through FrameCount % m (every
            # fc-consuming pass declares frame_count_modN and no pass
            # reads Time — ShaderEngine.cpp:2095-2145 semantics), and
            # the batch is a whole number of periods. Frame i's fc mod m
            # is (r0 + i) % m, so the batch splits into m POSITIONS each
            # holding nb/m frames with ONE concrete fc value. Concrete fc
            # lets fc-dependent spatial fields (ntsc chroma-phase trig,
            # scanline phase) fold to trace-time constants shared across
            # the group's vmap axis instead of being recomputed per
            # frame — the ntsc pass0 "4x its math" plumbing tax was this.
            m_p, r0 = fc_group

            def batch_fn(raw_b, state: _ChainState, pvals=None, lut_vals=None):
                src_b, sq = normalize(raw_b)
                lut = dict(zip(lut_names, lut_vals)) if lut_vals is not None else None
                nb = src_b.shape[0]
                g = nb // m_p
                grouped = src_b.reshape((g, m_p) + src_b.shape[1:])

                def one(src, fc):
                    out, _, _ = single(
                        src,
                        state.history,
                        state.feedback,
                        fc,
                        np.float32(0.0),  # fc_period proved Time unused
                        pvals,
                        blit=False,
                        src_quant=sq,
                        lut_data=lut,
                    )
                    return out

                pos = [
                    jax.vmap(lambda s, _fc=np.int32((r0 + p) % m_p): one(s, _fc))(
                        grouped[:, p]
                    )
                    for p in range(m_p)
                ]
                outs = jnp.stack(pos, axis=1)
                outs = outs.reshape((nb,) + outs.shape[2:])
                outs = finalize(outs[..., :3])
                return outs, _ChainState(
                    state.history,
                    state.feedback,
                    state.frame_count + nb,
                    state.time + jnp.float32(0.016) * nb,
                )

        elif temporal:

            def batch_fn(raw_b, state: _ChainState, pvals=None, lut_vals=None):
                src_b, sq = normalize(raw_b)
                lut = dict(zip(lut_names, lut_vals)) if lut_vals is not None else None

                def step(carry, src):
                    hist, fb, fc, tm = carry
                    # Viewport blit is stateless — hoisted out of the scan
                    # so it runs batched instead of per frame.
                    # Factored evaluation is disabled inside the scan: its
                    # concrete-index gathers compile pathologically under
                    # lax.scan and run per-step instead of batched
                    # (feedback-ghost regressed 1937 -> 223 fps).
                    out, hist, fb = single(
                        src, hist, fb, fc, tm, pvals, blit=False,
                        allow_factored=False, src_quant=sq, lut_data=lut,
                    )
                    return (hist, fb, fc + 1, tm + jnp.float32(0.016)), out

                carry0 = (state.history, state.feedback, state.frame_count, state.time)
                carry, outs = jax.lax.scan(step, carry0, src_b)
                hist, fb, fc, tm = carry
                outs = finalize(outs[..., :3])
                return outs, _ChainState(hist, fb, fc, tm)

        else:

            def batch_fn(raw_b, state: _ChainState, pvals=None, lut_vals=None):
                src_b, sq = normalize(raw_b)
                lut = dict(zip(lut_names, lut_vals)) if lut_vals is not None else None
                nb = src_b.shape[0]
                # Per-frame FrameCount/Time: the reference increments once
                # per frame (ShaderEngine.cpp:1685-1689), so frame i of a
                # batch must see fc+i — one shared fc would freeze
                # time-dependent shaders (noise, scanline phase) within
                # every batch.
                fcs = state.frame_count + jnp.arange(nb, dtype=jnp.int32)
                tms = state.time + jnp.float32(0.016) * jnp.arange(
                    nb, dtype=jnp.float32
                )

                def one(src, fc, tm):
                    out, _, _ = single(
                        src,
                        state.history,
                        state.feedback,
                        fc,
                        tm,
                        pvals,
                        blit=False,
                        src_quant=sq,
                        lut_data=lut,
                    )
                    return out

                outs = finalize(jax.vmap(one)(src_b, fcs, tms)[..., :3])
                n = src_b.shape[0]
                return outs, _ChainState(
                    state.history,
                    state.feedback,
                    state.frame_count + n,
                    state.time + jnp.float32(0.016) * n,
                )

        # Public jit signatures (LUTs ride as trailing positional args):
        #   (raw, state[, pvals][, lut_vals])
        inner_fn = batch_fn
        if traced_params:
            if lut_names:

                def batch_fn(raw_b, state, pvals, lut_vals):  # noqa: F811
                    return inner_fn(raw_b, state, pvals, lut_vals)

            else:

                def batch_fn(raw_b, state, pvals):  # noqa: F811
                    return inner_fn(raw_b, state, pvals)

        else:
            if lut_names:

                def batch_fn(raw_b, state, lut_vals):  # noqa: F811
                    return inner_fn(raw_b, state, None, lut_vals)

            else:

                def batch_fn(raw_b, state):  # noqa: F811
                    return inner_fn(raw_b, state)

        if self._mesh is not None and not temporal and not u8:
            # Data-parallel over the mesh: frames shard over 'data' (and
            # optionally W over 'space'); temporal-state scalars replicate.
            from retrocapture_tpu.parallel.mesh import frame_sharding, replicated

            fs = frame_sharding(self._mesh, spatial=self._spatial)
            rep = replicated(self._mesh)
            state_sh = jax.tree.map(lambda _: rep, self._state_proto(key))
            in_sh = (fs, state_sh)
            if traced_params:
                in_sh = in_sh + ({k: rep for k in params},)
            if lut_names:
                in_sh = in_sh + (tuple(rep for _ in lut_names),)
            fn = jax.jit(batch_fn, in_shardings=in_sh, out_shardings=(fs, state_sh))
        else:
            fn = self._pool_wrap_impl(batch_fn)
        if lut_names:
            # Callers keep the (frames, state[, pvals]) signature; the
            # wrapper appends the device-resident LUT tuple per call.
            jfn = fn
            lut_dev = self._lut_device_arrays(lut_names)
            if traced_params:
                fn = lambda r, s, p, _j=jfn, _l=lut_dev: _j(r, s, p, _l)  # noqa: E731
            else:
                fn = lambda r, s, _j=jfn, _l=lut_dev: _j(r, s, _l)  # noqa: E731
        self._jit_cache[cache_key] = fn
        return fn

    @staticmethod
    def _pool_wrap_impl(batch_fn):
        """jit with a lazily-discovered large-constant pool.

        Windowed-resampler chains (jinc2 & friends) fold per-tap weight
        fields into genuinely-2D [oh, ow] concrete constants; embedded
        as HLO literals they dominate program size, and with it compile
        time and compile memory. On the first concrete call, a throwaway
        abstract trace (jax.eval_shape under a collect-mode ConstPool)
        discovers those constants; if any exist, the real jit retraces
        with them passed as ARGUMENTS (replay-mode pool) — the LUT
        treatment of r3, generalized. Chains with no such constants
        keep the exact plain-jit path; nested traces (apply_streams
        vmaps this fn) are detected via tracer args and also take the
        plain path, preserving their current semantics."""
        from retrocapture_tpu.frontend.values import ConstPool, const_pool_scope

        plain = jax.jit(batch_fn)
        chosen: dict = {}

        def wrapped(*args):
            leaves = jax.tree_util.tree_leaves(args)
            if any(isinstance(x, jax.core.Tracer) for x in leaves):
                return plain(*args)
            fn = chosen.get("fn")
            if fn is None:
                pool = ConstPool("collect")
                try:
                    with const_pool_scope(pool):
                        jax.eval_shape(batch_fn, *args)
                except Exception:  # noqa: BLE001 - discovery is optional
                    pool.arrays = []
                if pool.arrays:
                    keys = dict(pool.keys)

                    def pooled(args2, pool_vals):
                        p2 = ConstPool("replay")
                        p2.keys = keys
                        p2.replay = list(pool_vals)
                        with const_pool_scope(p2):
                            return batch_fn(*args2)

                    dev = tuple(jax.device_put(a) for a in pool.arrays)
                    jfn = jax.jit(pooled)
                    log.info(
                        "const pool: %d grids, %.1f MB as jit args",
                        len(dev),
                        sum(a.nbytes for a in pool.arrays) / 1e6,
                    )
                    fn = lambda *a, _j=jfn, _d=dev: _j(a, _d)  # noqa: E731
                else:
                    fn = plain
                chosen["fn"] = fn
            return fn(*args)

        return wrapped

    def _lut_device_arrays(self, lut_names):
        """Device-put each LUT once per (engine, program); reused by every
        jit key so repeated apply() calls transfer nothing."""
        cache = self._lut_dev_cache
        if cache is not None and cache[0] is self._program:
            return cache[1]
        import numpy as _np

        vals = tuple(
            jax.device_put(_np.asarray(self._program.luts[n].data))
            for n in lut_names
        )
        self._lut_dev_cache = (self._program, vals)
        return vals

    def _state_proto(self, key):
        """A structural skeleton of the chain state for sharding trees."""
        return self._get_state(key, jnp.float32)


def _npz_path(path: str) -> str:
    """np.savez appends .npz when absent — normalize so a checkpoint
    saved as 'state' loads back as 'state'."""
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def _history_entry(src, out_w: int, out_h: int):
    """Build a frame-history ring entry from a frame: resize to the ring
    shape with the LINEAR blit and quantize to RGBA8, exactly like the
    in-chain history update (the GL copy into a GL_RGBA/UNSIGNED_BYTE
    texture, ShaderEngine.cpp:1744-1756)."""
    if src.shape[0] != out_h or src.shape[1] != out_w:
        u, v = _grids(out_w, out_h)
        src = sample2d(src, u, v, filter_linear=True)
    return framebuffer_store(src, float_framebuffer=False, srgb_framebuffer=False)


@jax.jit
def _quantize_u8(x):
    return jnp.round(jnp.clip(x, 0.0, 1.0) * 255.0).astype(jnp.uint8)


# jax.tree registration for _ChainState
jax.tree_util.register_pytree_node(
    _ChainState,
    lambda s: ((s.history, s.feedback, s.frame_count, s.time), None),
    lambda _, c: _ChainState(*c),
)


# ---------------------------------------------------------------------------
# Chain execution (traced)


def _run_chain(*args, **kwargs):
    """Execute every pass of a compiled preset for one frame, with
    cross-tap dedup scoped to the chain: NEAREST neighborhood taps on the
    same texture share y-products and extended x-matmul planes
    (ops/sampling.tap_dedup_scope — xbr-lv2's 21 one-hot tap matmuls
    collapse to 5 shared planes + slices)."""
    from retrocapture_tpu.ops.sampling import tap_dedup_scope

    with tap_dedup_scope():
        return _run_chain_impl(*args, **kwargs)


def _run_chain_impl(
    prog: PresetProgram,
    shapes: list[PassShapes],
    viewport: tuple[int, int],
    source,  # [h, w, 4] float32
    history: tuple,
    feedback: dict[int, Any],
    frame_count,
    time,
    params: dict[str, float],
    blit: bool = True,
    allow_factored: bool = True,
    source_quantized: bool = False,
    lut_data=None,
):
    """Execute every pass of a compiled preset for one frame. FrameCount
    increments once per frame, not per pass (ShaderEngine.cpp:1685-1689);
    history updates most-recent-first with the *final* processed output
    (:1731-1865); feedback ping-pong swaps at frame end (:1710-1718)."""
    n = len(prog.passes)
    src_h, src_w = source.shape[0], source.shape[1]
    preset = prog.preset

    def filter_of_output(j: int) -> tuple[bool, str, bool]:
        # Output of pass j carries the texture state last applied by the
        # pass that consumed it as input (j+1); the final pass's output
        # keeps the FBO defaults LINEAR/clamp (createFramebuffer).
        if j + 1 < n:
            cfg = preset.passes[j + 1]
            return cfg.filter_linear, cfg.wrap_mode, cfg.mipmap_input
        return True, "clamp_to_edge", False

    def _stored_quant(j: int) -> bool:
        cfg_j = preset.passes[j]
        return not cfg_j.float_framebuffer and not cfg_j.srgb_framebuffer

    original_binding = TexBinding(
        source,
        preset.passes[0].filter_linear,
        preset.passes[0].wrap_mode,
        preset.passes[0].mipmap_input,
        quantized=source_quantized,
    )
    # History entries are RGBA8 copies (framebuffer_store below).
    history_bindings = [
        TexBinding(t, True, "clamp_to_edge", quantized=True) for t in history
    ]

    pass_outputs: list[Optional[TexBinding]] = []
    outputs_raw: list = []
    current = source
    cur_quant = source_quantized
    for i, cp in enumerate(prog.passes):
        cfg = preset.passes[i]
        sh = shapes[i]
        input_binding = TexBinding(
            current, cfg.filter_linear, cfg.wrap_mode, cfg.mipmap_input,
            quantized=cur_quant,
        )
        fb_bindings = {
            j: TexBinding(t, *filter_of_output(j), quantized=_stored_quant(j))
            for j, t in feedback.items()
        }
        ctx = PassContext(
            prog,
            i,
            shapes=shapes,
            viewport=viewport,
            source_size=(src_w, src_h),
            input_binding=input_binding,
            original_binding=original_binding,
            pass_outputs=pass_outputs,
            history=history_bindings,
            feedback=fb_bindings,
            frame_count=frame_count,
            frame_time=time,
            params={
                k: (np.float32(v) if isinstance(v, (int, float, np.generic)) else v)
                for k, v in params.items()
            },
            lut_data=lut_data,
        )
        ctx.allow_factored = allow_factored
        color = _run_pass(cp, ctx, sh)
        stored = framebuffer_store(
            color,
            float_framebuffer=cfg.float_framebuffer,
            srgb_framebuffer=cfg.srgb_framebuffer,
        )
        outputs_raw.append(stored)
        pass_outputs.append(
            TexBinding(stored, *filter_of_output(i), quantized=_stored_quant(i))
        )
        current = stored
        cur_quant = _stored_quant(i)

    final = current

    # History ring: the final pass output (at its own size,
    # ShaderEngine.cpp:1744-1756) quantized to RGBA8 like the copy into a
    # GL_RGBA/UNSIGNED_BYTE texture.
    new_history = history
    if history:
        hh, hw = history[0].shape[0], history[0].shape[1]
        if final.shape[0] != hh or final.shape[1] != hw:
            u, v = _grids(hw, hh)
            entry = sample2d(final, u, v, filter_linear=True)
        else:
            entry = final
        entry = framebuffer_store(entry, float_framebuffer=False, srgb_framebuffer=False)
        new_history = (entry,) + tuple(history[:-1])

    # Feedback ping-pong: this frame's outputs become next frame's
    # PassFeedback textures.
    new_feedback = {j: outputs_raw[j] for j in feedback}

    # Final window blit (OpenGLRenderer::renderTexture): stretch the last
    # pass output to the viewport with the FBO texture's LINEAR filter.
    # Alpha is dropped first — the consumer only sees RGB, and the blit is
    # the bandwidth-dominant tensor of the whole chain at 1080p.
    final = final[..., :3]
    vw, vh = viewport
    if blit and (final.shape[0] != vh or final.shape[1] != vw):
        u, v = _grids(vw, vh)
        final = sample2d(final, u, v, filter_linear=True)

    return final, new_history, new_feedback


def _run_pass(cp, ctx: PassContext, sh: PassShapes):
    """One pass: vertex stage over the output grid → varyings; fragment
    stage → [oh, ow, 4] color.

    Benchmark-family fragments with a kernel-library entry
    (graph/kernels.py) take that path; the evaluator below is the
    general path and the semantic reference.

    The pixel grids are seeded as *traced* iota-derived arrays carrying
    affine metadata (values.py): coordinate math stays O(1) at trace time
    and stays out of the HLO as constants; separable taps lower to
    slices or matmuls via the metadata, warped taps to on-device gathers."""
    from retrocapture_tpu.graph.factored import FactoredBailout, plan_factorization
    from retrocapture_tpu.graph.kernels import find_kernel

    hand = find_kernel(ctx.program.preset.passes[cp.index].shader_path)
    if hand is not None:
        out = hand(ctx, sh)
        if out is not None:
            return out

    # Phase-factored evaluation for scaling passes (graph/factored.py):
    # run on the [my, ry, mx, rx] grid so tap-derived math stays at
    # source resolution; bail back to the plain grid on any construct
    # the factored tap lowering cannot express. Only NEAREST-filtered
    # passes factor: LINEAR taps are phase-dependent on both axes, so
    # factoring buys nothing and its full-resolution gather
    # materializations cost more than the separable matmuls.
    fac = None
    if (
        not ctx.program.preset.passes[cp.index].filter_linear
        and getattr(ctx, "allow_factored", True)
    ):
        fac = plan_factorization(sh.out_h, sh.out_w, sh.in_h, sh.in_w)
    if fac is not None:
        ctx.factored = fac
        try:
            return _eval_pass_on_grid(cp, ctx, sh, fac)
        except FactoredBailout:
            pass
        finally:
            ctx.factored = None
    ctx.factored = None
    return _eval_pass_on_grid(cp, ctx, sh, None)


def _quad_transform(v_globals, ow: int, oh: int):
    """Inverse rasterization map for a non-identity ``gl_Position``.

    Most corpus vertex shaders emit ``gl_Position = MVPMatrix *
    VertexCoord`` — a fullscreen quad, for which evaluating varyings
    directly on the output grid is exact.  A handful (lcd-shader,
    imgborder, cocktail-cabinet, hqx single-pass, braid-rewind) *scale*
    the clip position, shrinking the quad to a sub-region of the
    render target (the integer-prescale-with-borders trick).  The
    reference rasterizes that quad into a transparent-black-cleared FBO
    (ShaderEngine's per-pass glClear; see OpenGLRenderer FBO setup), so
    uncovered pixels are (0,0,0,0).

    The evaluator seeds the vertex stage on the output pixel grid and
    tracks clip position as an affine function of (col, row).  When the
    evaluated ``gl_Position`` differs from the identity quad, invert the
    affine map: for each *real* output pixel, find the seeded grid
    coordinate whose transformed clip position lands there, re-run the
    vertex stage on those coordinates, and mask pixels that fall
    outside the quad.  Returns ``((axx, axy, bx), (ayx, ayy, by))``
    with ``col' = axx*col + axy*row + bx`` (likewise row'), or None
    when gl_Position is the identity quad / not analyzable (the
    historical fullscreen assumption)."""
    from retrocapture_tpu.frontend.values import affine_of

    gp = v_globals.get("gl_Position")
    if not isinstance(gp, V) or gp.type.shape != (4,):
        return None
    aff = affine_of(gp, 4)
    if aff is None:
        return None
    (ax, bx, cx), (ay, by, cy), _zt, (aw, bw, cw) = aff
    # Only w == 1 (no perspective) is invertible as a 2-D affine map.
    if aw != 0.0 or bw != 0.0 or abs(cw - 1.0) > 1e-9:
        return None
    import math

    def close(u, v):
        return math.isclose(u, v, rel_tol=1e-6, abs_tol=1e-9)

    if (
        close(ax, 2.0 / ow)
        and close(bx, 0.0)
        and close(cx, 1.0 / ow - 1.0)
        and close(ay, 0.0)
        and close(by, 2.0 / oh)
        and close(cy, 1.0 / oh - 1.0)
    ):
        return None  # identity fullscreen quad
    det = ax * by - bx * ay
    if abs(det) < 1e-12:
        return None
    # Seeded clip = A·(col,row) + c; target NDC of real pixel (col0,row0)
    # is ((2/ow)·col0 + 1/ow − 1, (2/oh)·row0 + 1/oh − 1).  Solve
    # A·(col',row') = q − c for the pre-image grid coordinate.
    gx, hx = 2.0 / ow, 1.0 / ow - 1.0 - cx
    gy, hy = 2.0 / oh, 1.0 / oh - 1.0 - cy
    return (
        (by * gx / det, -bx * gy / det, (by * hx - bx * hy) / det),
        (-ay * gx / det, ax * gy / det, (-ay * hx + ax * hy) / det),
    )


_GL_INTERP = os.environ.get("RCTPU_GL_INTERP", "1") != "0"
_CONCRETE_FC = os.environ.get("RCTPU_CONCRETE_FC", "0") == "1"
# fc-period batch grouping (bit-identical; RCTPU_FC_GROUP=0 disables
# for on-chip A/Bs of the grouped-vs-per-frame lowering).
_FC_GROUP = os.environ.get("RCTPU_FC_GROUP", "1") != "0"


def _plane_setup_f32_pos(p0, p1, p2, a0v, a1v, a2v):
    """llvmpipe plane setup from arbitrary (snapped) screen-space
    triangle positions — the general form of _plane_setup_f32 used when
    ``gl_Position`` is a non-identity quad (integer-prescale-with-border
    vertex shaders scale the clip position; the rasterized quad then
    covers a sub- or super-region of the render target)."""
    f = np.float32
    x0, y0 = f(p0[0]), f(p0[1])
    x1, y1 = f(p1[0]), f(p1[1])
    x2, y2 = f(p2[0]), f(p2[1])
    a0v, a1v, a2v = f(a0v), f(a1v), f(a2v)
    dx01 = f(x0 - x1)
    dy01 = f(y0 - y1)
    dx20 = f(x2 - x0)
    dy20 = f(y2 - y0)
    area = f(f(dx01 * dy20) - f(dx20 * dy01))
    if area == 0.0:
        return None
    ooa = f(f(1.0) / area)
    da01 = f(a0v - a1v)
    da20 = f(a2v - a0v)
    dadx = f(f(da01 * f(dy20 * ooa)) - f(da20 * f(dy01 * ooa)))
    dady = f(f(da20 * f(dx01 * ooa)) - f(da01 * f(dx20 * ooa)))
    a0 = f(a0v - f(f(dadx * f(x0 - f(0.5))) + f(dady * f(y0 - f(0.5)))))
    return a0, dadx, dady


def _snap16(x):
    """lp_setup's 1/16-subpixel fixed-point vertex snapping."""
    return np.float32(np.round(np.float64(x) * 16.0) / 16.0)


def _quad_screen_corners(gp, ow: int, oh: int):
    """Screen-space (col, row) corners from concrete gl_Position corner
    values [[c00,c10],[c01,c11]] (vec4), via the GL viewport transform +
    1/16 snapping. Returns (corners dict, identity flag) or None when
    not an affine no-perspective quad."""
    arr = np.asarray(gp, np.float64)
    if arr.shape != (2, 2, 4):
        return None
    ws = arr[..., 3]
    if not np.allclose(ws, 1.0, rtol=0, atol=1e-9):
        return None
    sx = _snap16((arr[..., 0] * 0.5 + 0.5) * ow)
    sy = _snap16((arr[..., 1] * 0.5 + 0.5) * oh)
    ident = (
        np.array_equal(sx, np.array([[0.0, ow], [0.0, ow]], np.float32))
        and np.array_equal(sy, np.array([[0.0, 0.0], [oh, oh]], np.float32))
    )
    return (sx, sy), ident


def _plane_setup_f32(w: int, h: int, c10, c11, c01):
    """llvmpipe triangle-plane setup, bit-exact (probed 2026-08-17 over
    7 viewport sizes against the real-GL oracle with RGBA32F readback).

    The oracle draws the fullscreen quad as a TRIANGLE_STRIP whose second
    triangle is (v1, v3, v2) = ((w,0), (w,h), (0,h)) in screen pixels
    (gloracle.cpp:386-392, 558); Mesa's lp_setup computes each attribute
    plane as a0/dadx/dady in float32 with exactly this operation order,
    folding the half-pixel center into a0.  Per-pixel evaluation is then
    ``f32(f32(a0 + dadx*x) + dady*y)`` at INTEGER pixel coords, each
    step single-rounded (fma).  Reproducing these exact bits is what
    decides the knife-edge ``mod(vTexCoord, cell) > texel`` comparisons
    the handheld/lcd dot-matrix shaders build their grids from."""
    f = np.float32
    x0, y0, a0v = f(w), f(0.0), f(c10)
    x1, y1, a1v = f(w), f(h), f(c11)
    x2, y2, a2v = f(0.0), f(h), f(c01)
    dx01 = f(x0 - x1)
    dy01 = f(y0 - y1)
    dx20 = f(x2 - x0)
    dy20 = f(y2 - y0)
    area = f(f(dx01 * dy20) - f(dx20 * dy01))
    ooa = f(f(1.0) / area)
    da01 = f(a0v - a1v)
    da20 = f(a2v - a0v)
    dadx = f(f(da01 * f(dy20 * ooa)) - f(da20 * f(dy01 * ooa)))
    dady = f(f(da20 * f(dx01 * ooa)) - f(da01 * f(dx20 * ooa)))
    a0 = f(a0v - f(f(dadx * f(x0 - f(0.5))) + f(dady * f(y0 - f(0.5)))))
    return a0, dadx, dady


def _plane_component(a0, dadx, dady, ow: int, oh: int):
    """Per-pixel plane evaluation ``f32(f32(a0 + dadx*x) + dady*y)`` at
    integer pixel coords, as a CONCRETE numpy broadcast view.

    Concreteness is the point: the fragment evaluator then runs every
    varying-derived expression (floor/fract/clamp texel sharpening,
    scanline sin factors, ...) in numpy at trace time, so coordinate
    math reaches the samplers as concrete per-axis vectors — eligible
    for the gather-free repeat-slice taps — and per-pixel factors fold
    to constants instead of costing full-resolution HBM passes at run
    time. The device boundary rebuilds axis structure (engine/_cw
    `smart_device`) so no [oh, ow] HLO literal is ever emitted (the
    round-1 155 s compile pathology)."""
    inner = (np.float64(dadx) * np.arange(ow, dtype=np.float64) + np.float64(a0)).astype(
        np.float32
    )
    if dady == 0.0:
        return np.broadcast_to(inner[None, :], (oh, ow))
    if dadx == 0.0:
        col = (np.float64(dady) * np.arange(oh, dtype=np.float64) + np.float64(a0)).astype(
            np.float32
        )
        return np.broadcast_to(col[:, None], (oh, ow))
    return (
        inner[None, :].astype(np.float64)
        + np.float64(dady) * np.arange(oh, dtype=np.float64)[:, None]
    ).astype(np.float32)


def _plane_component_fac(a0, dadx, dady, fac):
    """Plane evaluation on a factored [ry,rx,my,mx] grid: the seeds are
    true pixel indices, so the per-axis plane vectors are computed
    host-side at exactly those indices with the same single-rounded
    float32 math as the plain grid. 2-D planes would need a full
    factored-volume constant — bail back to the plain grid instead."""
    from retrocapture_tpu.graph.factored import FactoredBailout

    if dady == 0.0:
        vec = (
            np.float64(dadx) * fac.xidx.T.astype(np.float64) + np.float64(a0)
        ).astype(np.float32)
        return jnp.asarray(vec).reshape(1, fac.rx, 1, fac.mx)
    if dadx == 0.0:
        vec = (
            np.float64(dady) * fac.yidx.T.astype(np.float64) + np.float64(a0)
        ).astype(np.float32)
        return jnp.asarray(vec).reshape(fac.ry, 1, fac.my, 1)
    raise FactoredBailout("2-D plane varying in factored mode")


def _plane_varyings(cp, ctx: PassContext, ow: int, oh: int, fac=None):
    """Rasterizer-exact varyings: evaluate the vertex stage at the four
    quad corners only (what GL hardware does), then rebuild each varying
    over the output grid with llvmpipe's plane equation in float32.

    This replaces the historical per-pixel vertex evaluation for two
    reasons of GL semantics:
    1. float32 rounding — interpolated values differ from per-pixel
       formula evaluation in ulps, and dot-matrix shaders branch on
       exact ties of those bits (handheld/lcd families);
    2. non-affine vertex math (cos/floor of TexCoord, etc.) must be
       computed at corners and linearly interpolated, not evaluated
       per-pixel.

    Returns {varying name -> V} for every float varying whose corner
    values are concrete, {} when the vertex stage can't be corner-run
    (traced uniforms in traced-param mode, vertex texture fetches...)."""
    f = np.float32
    tc = np.array(
        [[[0, 0, 0, 1], [1, 0, 0, 1]], [[0, 1, 0, 1], [1, 1, 0, 1]]], np.float32
    )
    vc = np.array(
        [[[-1, -1, 0, 1], [1, -1, 0, 1]], [[-1, 1, 0, 1], [1, 1, 0, 1]]], np.float32
    )
    t4 = GType("float", (4,))
    tex_v = V(tc, t4)
    vert_v = V(vc, t4)
    col_v = V(np.ones(4, np.float32), t4)
    ins = {
        "TexCoord": tex_v,
        "VertexCoord": vert_v,
        "Position": vert_v,
        "COLOR": col_v,
        "Color": col_v,
        "gl_Position": vert_v,
        "PrevTexCoord": tex_v,
    }
    for n in range(1, 7):
        ins[f"Prev{n}TexCoord"] = tex_v
    try:
        v_globals, _, _ = cp.vertex_eval.run(ctx, ins)
    except Exception:
        return {}, None
    from retrocapture_tpu.frontend.values import is_concrete

    # Screen-space corner positions from gl_Position (viewport transform
    # + 1/16 vertex snapping): identity quads use the probed integer-
    # corner setup; scaled quads (integer-prescale-with-border vertex
    # shaders) interpolate across their actual rasterized rectangle and
    # come with a coverage mask (pixels outside are cleared black by the
    # per-pass glClear).
    gp = v_globals.get("gl_Position")
    if not isinstance(gp, V) or not is_concrete(gp.data):
        return {}, None
    try:
        gp_c = np.broadcast_to(np.asarray(gp.data, np.float32), (2, 2, 4))
    except ValueError:
        return {}, None
    qc = _quad_screen_corners(gp_c, ow, oh)
    if qc is None:
        return {}, None
    (qsx, qsy), identity_quad = qc
    cover = None
    if not identity_quad:
        if fac is not None:
            from retrocapture_tpu.graph.factored import FactoredBailout

            raise FactoredBailout("non-identity gl_Position quad")
        xlo, xhi = float(qsx.min()), float(qsx.max())
        ylo, yhi = float(qsy.min()), float(qsy.max())
        covx = ((np.arange(ow, dtype=np.float64) + 0.5) >= xlo) & (
            (np.arange(ow, dtype=np.float64) + 0.5) < xhi
        )
        covy = ((np.arange(oh, dtype=np.float64) + 0.5) >= ylo) & (
            (np.arange(oh, dtype=np.float64) + 0.5) < yhi
        )
        cover = (covy, covx)

    out = {}
    for name in cp.vertex_eval.varying_names:
        cv = v_globals.get(name)
        if not isinstance(cv, V) or cv.type.base != "float":
            continue
        if not is_concrete(cv.data):
            continue
        comps = cv.type.shape[0] if cv.type.is_vector else 1
        try:
            arr = np.broadcast_to(
                np.asarray(cv.data, np.float32), (2, 2, comps) if cv.type.is_vector else (2, 2)
            )
        except ValueError:
            continue
        if not cv.type.is_vector:
            arr = arr[..., None]
        planes = []
        affs = []
        ok = True
        for k in range(comps):
            c00, c10, c01, c11 = arr[0, 0, k], arr[0, 1, k], arr[1, 0, k], arr[1, 1, k]
            if not np.all(np.isfinite([c00, c10, c01, c11])):
                ok = False
                break
            if identity_quad:
                plane = _plane_setup_f32(ow, oh, c10, c11, c01)
            else:
                plane = _plane_setup_f32_pos(
                    (qsx[0, 1], qsy[0, 1]),
                    (qsx[1, 1], qsy[1, 1]),
                    (qsx[1, 0], qsy[1, 0]),
                    c10,
                    c11,
                    c01,
                )
                if plane is None:
                    ok = False
                    break
            a0, dadx, dady = plane
            comp = (
                _plane_component_fac(a0, dadx, dady, fac)
                if fac is not None
                else _plane_component(a0, dadx, dady, ow, oh)
            )
            # Non-planar f32 corners (genuinely bilinear varyings) render
            # as two triangle planes with a diagonal seam in GL; stitch
            # the first-triangle plane over its half.
            resid = (float(c11) - float(c10)) - (float(c01) - float(c00))
            scale = max(abs(float(c)) for c in (c00, c10, c01, c11)) or 1.0
            if abs(resid) > 64.0 * np.spacing(np.float32(scale)) and identity_quad:
                if fac is not None:
                    from retrocapture_tpu.graph.factored import FactoredBailout

                    raise FactoredBailout("non-planar varying in factored mode")
                b0, bdx, bdy = _plane_setup_t012_f32(ow, oh, c00, c10, c01)
                compA = _plane_component(b0, bdx, bdy, ow, oh)
                xs = np.arange(ow, dtype=np.float32)[None, :] + np.float32(0.5)
                ys = np.arange(oh, dtype=np.float32)[:, None] + np.float32(0.5)
                lower = xs * np.float32(oh) + ys * np.float32(ow) < np.float32(ow * oh)
                comp = np.where(lower, compA, comp)
                affs = None
            if affs is not None:
                affs.append((float(dadx), float(dady), float(a0)))
            planes.append(comp)
        if not ok:
            continue
        if fac is not None:
            if cv.type.is_vector:
                shp = jnp.broadcast_shapes(*(p.shape for p in planes))
                data = jnp.stack(
                    [jnp.broadcast_to(p, shp) for p in planes], axis=-1
                )
            else:
                data = planes[0]
        else:
            data = np.stack(planes, axis=-1) if cv.type.is_vector else planes[0]
        out[name] = V(
            data,
            cv.type,
            affine=tuple(affs) if affs is not None and cv.type.is_vector else None,
        )
    return out, cover


def _plane_setup_t012_f32(w: int, h: int, c00, c10, c01):
    """Plane setup for the strip's FIRST triangle (v0,v1,v2) =
    ((0,0),(w,0),(0,h)) — used only to stitch non-planar (bilinear)
    varyings across the quad diagonal."""
    f = np.float32
    x0, y0, a0v = f(0.0), f(0.0), f(c00)
    x1, y1, a1v = f(w), f(0.0), f(c10)
    x2, y2, a2v = f(0.0), f(h), f(c01)
    dx01 = f(x0 - x1)
    dy01 = f(y0 - y1)
    dx20 = f(x2 - x0)
    dy20 = f(y2 - y0)
    area = f(f(dx01 * dy20) - f(dx20 * dy01))
    ooa = f(f(1.0) / area)
    da01 = f(a0v - a1v)
    da20 = f(a2v - a0v)
    dadx = f(f(da01 * f(dy20 * ooa)) - f(da20 * f(dy01 * ooa)))
    dady = f(f(da20 * f(dx01 * ooa)) - f(da01 * f(dx20 * ooa)))
    a0 = f(a0v - f(f(dadx * f(x0 - f(0.5))) + f(dady * f(y0 - f(0.5)))))
    return a0, dadx, dady


def _eval_pass_on_grid(cp, ctx: PassContext, sh: PassShapes, fac):
    ow, oh = sh.out_w, sh.out_h
    if fac is None:
        xg = jax.lax.broadcasted_iota(jnp.float32, (oh, ow), 1)  # column
        yg = jax.lax.broadcasted_iota(jnp.float32, (oh, ow), 0)  # row
        zeros = jnp.zeros((oh, ow), jnp.float32)
        ones = jnp.ones((oh, ow), jnp.float32)
    else:
        xg, yg = fac.seed_arrays()
        zeros = jnp.zeros((1, 1, 1, 1), jnp.float32)
        ones = jnp.ones((1, 1, 1, 1), jnp.float32)
    ugrid = (xg + 0.5) * np.float32(1.0 / ow)
    vgrid = (yg + 0.5) * np.float32(1.0 / oh)

    ua = (1.0 / ow, 0.0, 0.5 / ow)
    va = (0.0, 1.0 / oh, 0.5 / oh)
    c0 = (0.0, 0.0, 0.0)
    c1 = (0.0, 0.0, 1.0)

    def vec4(a, b, c, d, aff):
        shp = jnp.broadcast_shapes(*(jnp.shape(x) for x in (a, b, c, d)))
        comps = [jnp.broadcast_to(x, shp) for x in (a, b, c, d)]
        return V(jnp.stack(comps, axis=-1), GType("float", (4,)), affine=aff)

    tex_coord = vec4(ugrid, vgrid, zeros, ones, (ua, va, c0, c1))
    vertex_coord = vec4(
        ugrid * 2.0 - 1.0,
        vgrid * 2.0 - 1.0,
        zeros,
        ones,
        (
            (2.0 / ow, 0.0, 1.0 / ow - 1.0),
            (0.0, 2.0 / oh, 1.0 / oh - 1.0),
            c0,
            c1,
        ),
    )
    color_attr = V(np.ones(4, np.float32), GType("float", (4,)))

    def attr_inputs(tc, vc):
        # Attribute slot aliases per the reference's glBindAttribLocation
        # table (ShaderEngine.cpp:707-719): Position shares slot 0 with
        # VertexCoord; the motion-blur Prev*TexCoord attributes share
        # slot 1 with TexCoord (all frames use the same quad coords).
        ins = {
            "TexCoord": tc,
            "VertexCoord": vc,
            "Position": vc,
            "COLOR": color_attr,
            "Color": color_attr,
            "gl_Position": vc,
            "PrevTexCoord": tc,
        }
        for n in range(1, 7):
            ins[f"Prev{n}TexCoord"] = tc
        return ins

    v_inputs = attr_inputs(tex_coord, vertex_coord)
    v_globals, _, _ = cp.vertex_eval.run(ctx, v_inputs)

    cover = None
    planes = {}
    plane_cover = None
    if _GL_INTERP:
        # Rasterizer-exact varyings: corner-evaluate the vertex stage
        # and rebuild each varying with llvmpipe's float32 plane
        # equations (bit-parity for knife-edge mod/tie comparisons;
        # correct corner-interpolation semantics for non-affine vertex
        # math; scaled gl_Position quads interpolate across their
        # actual rasterized rectangle with a coverage mask).
        try:
            planes, plane_cover = _plane_varyings(cp, ctx, ow, oh, fac)
        except Exception as exc:
            if fac is not None:
                from retrocapture_tpu.graph.factored import FactoredBailout

                raise FactoredBailout(str(exc)) from exc
            planes, plane_cover = {}, None
    if planes and plane_cover is not None:
        # A transformed quad demands every consumed varying come from
        # the planes; a leftover identity-grid varying would be wrong.
        for name in cp.vertex_eval.varying_names:
            gv = v_globals.get(name)
            if isinstance(gv, V) and gv.type.base == "float" and name not in planes:
                planes, plane_cover = {}, None
                break
    if planes and plane_cover is not None:
        covy, covx = plane_cover
        cover = jnp.asarray(covy)[:, None] & jnp.asarray(covx)[None, :]
    quad = None if planes else _quad_transform(v_globals, ow, oh)
    if quad is not None:
        if fac is not None:
            from retrocapture_tpu.graph.factored import FactoredBailout

            raise FactoredBailout("non-identity gl_Position")
        (axx, axy, bx0), (ayx, ayy, by0) = quad
        xg2 = axx * xg + axy * yg + np.float32(bx0)
        yg2 = ayx * xg + ayy * yg + np.float32(by0)
        # Quad param covers col ∈ [-0.5, ow-0.5); fragments whose
        # pre-image falls outside are never rasterized → cleared black.
        cover = (
            (xg2 >= -0.5) & (xg2 < ow - 0.5) & (yg2 >= -0.5) & (yg2 < oh - 0.5)
        )

        def _comp(t):
            a, b, c = t
            return (a * axx + b * ayx, a * axy + b * ayy, a * bx0 + b * by0 + c)

        ugrid2 = (xg2 + 0.5) * np.float32(1.0 / ow)
        vgrid2 = (yg2 + 0.5) * np.float32(1.0 / oh)
        tex_coord = vec4(ugrid2, vgrid2, zeros, ones, (_comp(ua), _comp(va), c0, c1))
        vertex_coord = vec4(
            ugrid2 * 2.0 - 1.0,
            vgrid2 * 2.0 - 1.0,
            zeros,
            ones,
            (
                _comp((2.0 / ow, 0.0, 1.0 / ow - 1.0)),
                _comp((0.0, 2.0 / oh, 1.0 / oh - 1.0)),
                c0,
                c1,
            ),
        )
        v_inputs = attr_inputs(tex_coord, vertex_coord)
        v_globals, _, _ = cp.vertex_eval.run(ctx, v_inputs)

    f_inputs = {}
    for name in cp.vertex_eval.varying_names:
        if name in v_globals:
            f_inputs[name] = v_globals[name]
    f_inputs.update({n: pv for n, pv in planes.items() if n in f_inputs})
    if fac is None and quad is None and _GL_INTERP:
        # Concrete gl_FragCoord: per-axis numpy broadcast views, so
        # fragCoord-derived masks (comb patterns, interlace mod) fold at
        # trace time like the plane varyings do.
        xc = np.broadcast_to(
            (np.arange(ow, dtype=np.float32) + np.float32(0.5))[None, :], (oh, ow)
        )
        yc = np.broadcast_to(
            (np.arange(oh, dtype=np.float32) + np.float32(0.5))[:, None], (oh, ow)
        )
        fc_data = np.stack(
            [xc, yc, np.zeros((oh, ow), np.float32), np.ones((oh, ow), np.float32)],
            axis=-1,
        )
        frag_coord = V(
            fc_data,
            GType("float", (4,)),
            affine=((1.0, 0.0, 0.5), (0.0, 1.0, 0.5), c0, c1),
        )
    else:
        frag_coord = vec4(
            xg + 0.5,
            yg + 0.5,
            zeros,
            ones,
            ((1.0, 0.0, 0.5), (0.0, 1.0, 0.5), c0, c1),
        )
    f_inputs["gl_FragCoord"] = frag_coord

    _, out_color, discard_mask = cp.fragment_eval.run(ctx, f_inputs)
    if out_color is None:
        raise UnsupportedShaderError(f"pass {cp.index}: no output color written")
    from retrocapture_tpu.frontend.values import smart_device

    data = smart_device(out_color.data) if isinstance(
        out_color.data, np.ndarray
    ) else jnp.asarray(out_color.data)
    if discard_mask is not None and discard_mask is not False:
        if discard_mask is True:
            data = jnp.zeros_like(data)
        else:
            data = jnp.where(jnp.asarray(discard_mask)[..., None], 0.0, data)
    if cover is not None:
        data = jnp.where(cover[..., None], data, 0.0)
    if fac is not None:
        return fac.flatten(data)
    return jnp.broadcast_to(data, (oh, ow, 4))
