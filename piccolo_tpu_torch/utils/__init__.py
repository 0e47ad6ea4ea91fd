"""Utilities: profiling, timing, debug switches (port of
piccolo_tpu.utils)."""

from .profiling import (
    Timer,
    enable_compilation_cache,
    enable_nan_debug,
    maybe_trace,
)

__all__ = ["Timer", "enable_compilation_cache", "enable_nan_debug", "maybe_trace"]
