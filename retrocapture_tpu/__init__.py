"""retrocapture_tpu — a retro-shader video-processing framework on JAX.

A from-scratch reimplementation of the frame-processing core of
geldoronie/RetroCapture (reference: src/{shader,processing,renderer})
as an array program: RetroArch ``.glslp`` presets are parsed, their GLSL
passes are lowered to JAX/XLA, and multi-pass chains execute as fused,
jit-compiled programs over batched ``[B, H, W, 3]`` frame tensors.

Public API (mirrors the reference's ShaderEngine contract,
src/shader/ShaderEngine.h:54-93):

    from retrocapture_tpu import Engine
    eng = Engine()
    eng.load_preset("crt/crt-mattias.glslp")
    eng.set_parameter("CURVATURE", 0.3)
    out = eng.apply(frames)          # frames: uint8/float32 [H,W,3] or [B,H,W,3]
"""

import logging as _logging
import os as _os

__version__ = "0.1.0"

# The checkout root: the persistent compile cache lives at a fixed path
# inside it, because the cache path is part of the cache key.
_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache. Shape-specialized chains retrace
    per (source, viewport) pair; without a disk cache every process pays
    each compile again. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
    reads it itself and nothing is set here; otherwise the cache goes to
    ``<checkout>/.jax_cache`` (git-ignored)."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    loc = _os.path.join(_CHECKOUT, ".jax_cache")
    try:
        _os.makedirs(loc, exist_ok=True)
    except OSError as e:  # read-only checkout: run uncached, say so
        _logging.getLogger(__name__).warning(
            "compile cache disabled, cannot create %s: %s", loc, e
        )
        return
    jax.config.update("jax_compilation_cache_dir", loc)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compile_cache()

from retrocapture_tpu.presets.glslp import Preset, PassConfig, TextureConfig
from retrocapture_tpu.runtime.engine import Engine

__all__ = [
    "Engine",
    "Preset",
    "PassConfig",
    "TextureConfig",
    "__version__",
]
