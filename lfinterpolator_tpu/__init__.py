"""lfinterpolator_tpu — light-field view interpolation in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
ichlubna/lfInterpolator (CUDA): load a camera-grid light field, synthesize 64
novel views along a trajectory by shift-and-sum weighted blending (expressed
as one GEMM over the grid images), with optional per-pixel focus-map
estimation for all-in-focus rendering. On the GPU the disparity search runs
as a Pallas-Triton kernel (ops/estimate_triton.py). The entry points place
XLA's persistent compilation cache through utils/compile_cache.py.
"""

from .core.config import RenderConfig

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Interpolator",
    "RenderResult",
    "QuiltResult",
    "interpolate",
    "StreamingRenderer",
    "__version__",
]

_LAZY = {
    "Interpolator": ("lfinterpolator_tpu.api", "Interpolator"),
    "RenderResult": ("lfinterpolator_tpu.api", "RenderResult"),
    "QuiltResult": ("lfinterpolator_tpu.api", "QuiltResult"),
    "interpolate": ("lfinterpolator_tpu.api", "interpolate"),
    "StreamingRenderer": ("lfinterpolator_tpu.streaming", "StreamingRenderer"),
}


def __getattr__(name):
    """Lazy top-level exports (importing the package stays jax-free)."""
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
