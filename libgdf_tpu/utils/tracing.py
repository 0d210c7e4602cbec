"""Operator-scoped tracing ranges.

≅ the reference's NVTX layer: public gdf_nvtx_range_push[_hex]/pop
(functions.h:18-52, src/nvtx_utils.cpp:19-76) and the internal
PUSH_RANGE/POP_RANGE macros with per-operator colors (src/nvtx_utils.h:
17-66) wrapped around join/groupby/binaryops/hash-partition/CSV.

Equivalent here: jax.profiler.TraceAnnotation ranges (visible in
xprof/perfetto captures) with the same operator range names the reference
uses, plus jax.named_scope so the ranges also appear in HLO op names.
Colors become labels (the profiler UI colors by name).
"""
from __future__ import annotations

import contextlib
import threading

import jax

# ≅ gdf_color (types.h:140-150): named colors kept as labels.
GDF_GREEN = "green"
GDF_BLUE = "blue"
GDF_YELLOW = "yellow"
GDF_PURPLE = "purple"
GDF_CYAN = "cyan"
GDF_RED = "red"
GDF_WHITE = "white"
GDF_DARK_GREEN = "dark_green"
GDF_ORANGE = "orange"

_stack = threading.local()


def _ranges():
    if not hasattr(_stack, "r"):
        _stack.r = []
    return _stack.r


def range_push(name: str, color: str | int = GDF_GREEN) -> None:
    """≅ gdf_nvtx_range_push (src/nvtx_utils.cpp:19-40)."""
    ann = jax.profiler.TraceAnnotation(str(name))
    ann.__enter__()
    _ranges().append(ann)


def range_push_hex(name: str, color: int = 0) -> None:
    """≅ gdf_nvtx_range_push_hex (src/nvtx_utils.cpp:42-58)."""
    range_push(name, color)


def range_pop() -> None:
    """≅ gdf_nvtx_range_pop (src/nvtx_utils.cpp:60-76)."""
    r = _ranges()
    if r:
        r.pop().__exit__(None, None, None)


@contextlib.contextmanager
def op_range(name: str, color: str = GDF_GREEN):
    """Internal PUSH_RANGE/POP_RANGE analogue (src/nvtx_utils.h:36-66):
    wraps an operator body in both a profiler range and a named scope so
    the operator name survives into compiled HLO."""
    with jax.profiler.TraceAnnotation(name), jax.named_scope(name):
        yield
