"""Utilities: profiling, tracing, debug switches (port of
piccolo_tpu.utils)."""

from .profiling import (
    enable_compilation_cache,
    enable_nan_debug,
    maybe_trace,
)

__all__ = ["enable_compilation_cache", "enable_nan_debug", "maybe_trace"]
