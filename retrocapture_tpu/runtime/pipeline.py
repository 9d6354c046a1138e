"""Per-frame pipeline around the Engine — the JAX equivalent of
FrameCapturePipeline::renderAndDistributeFrame
(src/core/FrameCapturePipeline.cpp:93) plus the final
OpenGLRenderer::renderTexture blit (src/renderer/OpenGLRenderer.cpp:389).

Stages (all fused into the engine's single XLA program per shape):

1. *Logical-resolution downscale* — when a logical capture resolution is
   set and smaller than the source, the frame is downscaled with NEAREST
   so CRT shaders see pixelated low-res input as designed
   (FrameCapturePipeline.cpp:142-258);
2. *Overscan crop* — X/Y percent cropped from each side via the
   enlarged-viewport trick, clamped to 45% per side (:211-223);
3. the shader chain (runtime/engine.py);
4. *Final blit* — brightness/contrast/flip-Y as in the GL 3 fragment
   (OpenGLRenderer.cpp: ``color*brightness`` then
   ``(color-0.5)*contrast+0.5``) and letterbox/pillarbox viewport math
   (:449-463) with black bars.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from retrocapture_tpu.ops.sampling import sample2d
from retrocapture_tpu.runtime.engine import Engine, _grids

__all__ = ["FramePipeline", "ImageSettings"]


@dataclass
class ImageSettings:
    """The image controls the UI exposes (UIConfigurationImage)."""

    brightness: float = 1.0
    contrast: float = 1.0
    flip_y: bool = False
    maintain_aspect: bool = False


class FramePipeline:
    """Engine + source preparation + final blit, mirroring the per-frame
    path of the reference application."""

    def __init__(
        self,
        engine: Engine,
        *,
        logical_resolution: Optional[tuple[int, int]] = None,  # (W, H)
        overscan_percent: tuple[float, float] = (0.0, 0.0),  # X%, Y% per side
        image: Optional[ImageSettings] = None,
        window: Optional[tuple[int, int]] = None,  # (W, H) final blit target
    ):
        self.engine = engine
        self.logical_resolution = logical_resolution
        self.overscan_percent = overscan_percent
        self.image = image or ImageSettings()
        self.window = window
        self._prep_jit: dict = {}
        self._blit_jit: dict = {}
        from retrocapture_tpu.utils.metrics import FrameStats

        self.stats = FrameStats()

    # -- source preparation --------------------------------------------
    def _prepare(self, frames: jax.Array) -> jax.Array:
        """Logical-res NEAREST downscale + overscan crop (batched)."""
        b, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        lw, lh = self.logical_resolution or (0, 0)
        needs_downscale = 0 < lw < w and 0 < lh < h
        ox = float(np.clip(self.overscan_percent[0] / 100.0, 0.0, 0.45))
        oy = float(np.clip(self.overscan_percent[1] / 100.0, 0.0, 0.45))
        needs_overscan = ox > 1e-5 or oy > 1e-5
        if not needs_downscale and not needs_overscan:
            return frames
        fw, fh = (lw, lh) if needs_downscale else (w, h)
        # Overscan maps output [0,1] into the central visible fraction of
        # the source: u' = ox + u*(1-2*ox) (FrameCapturePipeline.cpp:211).
        u, v = _grids(fw, fh)
        u = (ox + u * (1.0 - 2.0 * ox)).astype(np.float32)
        v = (oy + v * (1.0 - 2.0 * oy)).astype(np.float32)

        key = (b, h, w, fw, fh, ox, oy)
        fn = self._prep_jit.get(key)
        if fn is None:
            fn = jax.jit(
                lambda fr: jax.vmap(
                    lambda t: sample2d(t, u, v, filter_linear=False)
                )(fr)
            )
            self._prep_jit[key] = fn
        return fn(frames)

    # -- final blit -----------------------------------------------------
    def _blit(self, frames: jax.Array) -> jax.Array:
        img = self.image
        if self.window is None and not img.flip_y and img.brightness == 1.0 and img.contrast == 1.0:
            return frames
        b, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
        ww, wh = self.window or (w, h)
        key = (b, h, w, ww, wh, img.brightness, img.contrast, img.flip_y, img.maintain_aspect)
        fn = self._blit_jit.get(key)
        if fn is None:
            # Letterbox/pillarbox placement (OpenGLRenderer.cpp:449-463).
            vx, vy, vw, vh = 0, 0, ww, wh
            if img.maintain_aspect and w > 0 and h > 0:
                tex_aspect = w / h
                win_aspect = ww / wh
                if tex_aspect > win_aspect:
                    vh = int(ww / tex_aspect)
                    vy = (wh - vh) // 2
                else:
                    vw = int(wh * tex_aspect)
                    vx = (ww - vw) // 2
            u, v = _grids(vw, vh)
            if img.flip_y:
                v = 1.0 - v
            brightness = np.float32(img.brightness)
            contrast = np.float32(img.contrast)

            def one(t):
                out = sample2d(t, u, v, filter_linear=True)
                out = out * brightness
                out = (out - 0.5) * contrast + 0.5
                out = jnp.clip(out, 0.0, 1.0)
                if (vx, vy, vw, vh) != (0, 0, ww, wh):
                    canvas = jnp.zeros((wh, ww, out.shape[-1]), out.dtype)
                    out = jax.lax.dynamic_update_slice(canvas, out, (vy, vx, 0))
                return out

            fn = jax.jit(lambda fr: jax.vmap(one)(fr))
            self._blit_jit[key] = fn
        return fn(frames)

    # -- public ---------------------------------------------------------
    def process(self, frames) -> jax.Array:
        """uint8/float [H,W,3] or [B,H,W,3] → float32 RGB at the window
        (or viewport) size, shader chain applied when loaded."""
        import time as _time

        t0 = _time.monotonic()
        arr = jnp.asarray(frames)
        batched = arr.ndim == 4
        if not batched:
            arr = arr[None]
        n = arr.shape[0]
        if arr.dtype == jnp.uint8:
            arr = arr.astype(jnp.float32) * (1.0 / 255.0)
        arr = self._prepare(arr)
        out = self.engine.apply(arr)
        out = self._blit(out)
        self.stats.tick(n, latency_s=_time.monotonic() - t0)
        return out if batched else out[0]
