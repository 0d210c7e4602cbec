"""Elementwise unary/binary/comparison ops with null propagation.

≅ reference operator families:
  - unary math + cast matrix: libgdf/src/unaryops.cu (sin/cos/tan/asin/acos/
    atan/exp/log/sqrt/ceil/floor :96-335; cast matrix incl. datetime
    unit scaling :338-497)
  - binary arithmetic/comparison/bitwise: libgdf/src/binaryops.cu
    (gpu_binary_op :9-31 — output valid only where BOTH inputs valid :22-24)
  - column-vs-scalar / column-vs-column comparisons producing int8 stencils:
    libgdf/src/filterops.cu (:17-95, 162-260)

Design: each op is a whole-column fused expression. The reference
launches one grid-stride kernel per op and *skips* invalid lanes
(unaryops.cu:18-43); we compute all lanes (branch-free, vector-friendly) and
carry the validity mask alongside — dead-lane results are never observed.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.bitmask import mask_and
from ..core.column import Column
from ..core.dtypes import DtypeInfo, GDFDtype, TimeUnit
from ..core.errors import GDFError, GDFStatus, require

# ---------------------------------------------------------------------------
# Unary math (unaryops.cu:96-335)
# ---------------------------------------------------------------------------

_UNARY_FNS = {
    "sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan,
    "asin": jnp.arcsin, "acos": jnp.arccos, "atan": jnp.arctan,
    "exp": jnp.exp, "log": jnp.log, "sqrt": jnp.sqrt,
    "ceil": jnp.ceil, "floor": jnp.floor,
}


def unary_op(col: Column, op: str) -> Column:
    """Apply a named unary math fn; validity passes through.

    ≅ gdf_sin_f32 … gdf_floor_f64 (unaryops.cu:96-335; f32/f64 only)."""
    require(op in _UNARY_FNS, GDFStatus.GDF_INVALID_API_CALL,
            f"unknown unary op {op!r}")
    require(col.info.is_floating, GDFStatus.GDF_UNSUPPORTED_DTYPE,
            f"{op} requires FLOAT32/FLOAT64")
    return col.with_data(_UNARY_FNS[op](col.data))


# Unary convenience wrappers
def sin(c): return unary_op(c, "sin")
def cos(c): return unary_op(c, "cos")
def tan(c): return unary_op(c, "tan")
def asin(c): return unary_op(c, "asin")
def acos(c): return unary_op(c, "acos")
def atan(c): return unary_op(c, "atan")
def exp(c): return unary_op(c, "exp")
def log(c): return unary_op(c, "log")
def sqrt(c): return unary_op(c, "sqrt")
def ceil(c): return unary_op(c, "ceil")
def floor(c): return unary_op(c, "floor")


# ---------------------------------------------------------------------------
# Cast matrix (unaryops.cu:338-497)
# ---------------------------------------------------------------------------

# Sub-day units per day for each datetime dtype/unit
# (unaryops.cu:385-462 scale constants).
def _units_per_day(info: DtypeInfo) -> int:
    d = info.gdf_dtype
    if d == GDFDtype.DATE32:
        return 1
    if d == GDFDtype.DATE64:
        return 86400000
    if d == GDFDtype.TIMESTAMP:
        return {
            TimeUnit.NONE: 86400000,  # default unit is ms (types.h:25)
            TimeUnit.s: 86400,
            TimeUnit.ms: 86400000,
            TimeUnit.us: 86400000000,
            TimeUnit.ns: 86400000000000,
        }[info.time_unit]
    raise GDFError(GDFStatus.GDF_UNSUPPORTED_DTYPE, f"not a datetime: {d}")


def cast(col: Column, to: GDFDtype,
         time_unit: TimeUnit = TimeUnit.NONE) -> Column:
    """Full 9x9 cast matrix incl. datetime unit scaling.

    ≅ gdf_cast_* (unaryops.cu:465-497). Datetime→datetime scales by the
    unit ratio: up-cast multiplies (UpCasting :346-352), down-cast floor-
    divides (DownCasting :354-361 implements floor for negatives)."""
    to_info = DtypeInfo(to, time_unit)
    from_info = col.info
    data = col.data
    if from_info.is_datetime and to_info.is_datetime:
        f, t = _units_per_day(from_info), _units_per_day(to_info)
        wide = data.astype(jnp.int64)
        if t >= f:
            out = wide * (t // f)
        else:
            out = jnp.floor_divide(wide, f // t)
        out = out.astype(to_info.physical)
    else:
        # Physical cast (DeviceCast :339-345): plain C-style conversion.
        out = data.astype(to_info.physical)
    return Column(data=out, valid=col.valid, info=to_info, name=col.name)


# ---------------------------------------------------------------------------
# Binary ops (binaryops.cu)
# ---------------------------------------------------------------------------

_ARITH = {
    "add": jnp.add, "sub": jnp.subtract, "mul": jnp.multiply,
    "div": jnp.divide, "floordiv": jnp.floor_divide,
    "bitwise_and": jnp.bitwise_and, "bitwise_or": jnp.bitwise_or,
    "bitwise_xor": jnp.bitwise_xor,
}
_CMP = {
    "gt": jnp.greater, "ge": jnp.greater_equal,
    "lt": jnp.less, "le": jnp.less_equal,
    "eq": jnp.equal, "ne": jnp.not_equal,
}


def _binary_valid(a: Column, b: Column):
    """Output valid where BOTH inputs valid (binaryops.cu:22-24)."""
    return mask_and(a.valid, b.valid)


def binary_op(a: Column, b: Column, op: str) -> Column:
    """Arithmetic/bitwise binary op; comparison ops return INT8 0/1
    (≅ gdf_gt_* etc., binaryops.cu output column is i8)."""
    require(a.size == b.size, GDFStatus.GDF_COLUMN_SIZE_MISMATCH)
    valid = _binary_valid(a, b)
    if op in _ARITH:
        out = _ARITH[op](a.data, b.data)
        info = a.info if out.dtype == a.info.physical else \
            DtypeInfo(_gdf_dtype_of(out.dtype))
        return Column(data=out.astype(info.physical), valid=valid,
                      info=info, name=a.name)
    if op in _CMP:
        out = _CMP[op](a.data, b.data).astype(jnp.int8)
        return Column(data=out, valid=valid,
                      info=DtypeInfo(GDFDtype.INT8), name=a.name)
    raise GDFError(GDFStatus.GDF_INVALID_API_CALL, f"unknown binop {op!r}")


def _gdf_dtype_of(np_dtype) -> GDFDtype:
    from ..core.dtypes import dtype_from_numpy
    import numpy as np
    return dtype_from_numpy(np.dtype(np_dtype))


def add(a, b): return binary_op(a, b, "add")
def sub(a, b): return binary_op(a, b, "sub")
def mul(a, b): return binary_op(a, b, "mul")
def div(a, b): return binary_op(a, b, "div")
def floordiv(a, b): return binary_op(a, b, "floordiv")
def gt(a, b): return binary_op(a, b, "gt")
def ge(a, b): return binary_op(a, b, "ge")
def lt(a, b): return binary_op(a, b, "lt")
def le(a, b): return binary_op(a, b, "le")
def eq(a, b): return binary_op(a, b, "eq")
def ne(a, b): return binary_op(a, b, "ne")
def bitwise_and(a, b): return binary_op(a, b, "bitwise_and")
def bitwise_or(a, b): return binary_op(a, b, "bitwise_or")
def bitwise_xor(a, b): return binary_op(a, b, "bitwise_xor")


# ---------------------------------------------------------------------------
# Column-vs-scalar comparisons → INT8 stencil (filterops.cu)
# ---------------------------------------------------------------------------

_CMP_ENUM = {  # gdf_comparison_operator, types.h:188-195
    0: "eq", 1: "ne", 2: "lt", 3: "le", 4: "gt", 5: "ge",
    "eq": "eq", "ne": "ne", "lt": "lt", "le": "le", "gt": "gt", "ge": "ge",
}


def compare_scalar(col: Column, value, op) -> Column:
    """column OP scalar → INT8 stencil column (1=pass).

    ≅ gpu_comparison_static_* (filterops.cu:17-95). Mixed numeric dtypes
    are compared after promotion (the reference uses typed iterators)."""
    op = _CMP_ENUM[op]
    out = _CMP[op](col.data, jnp.asarray(value)).astype(jnp.int8)
    return Column(data=out, valid=col.valid,
                  info=DtypeInfo(GDFDtype.INT8), name=col.name)


def compare(a: Column, b: Column, op) -> Column:
    """column OP column → INT8 stencil (≅ gpu_comparison,
    filterops.cu:162-260; supports mixed dtypes via promotion)."""
    op = _CMP_ENUM[op]
    require(a.size == b.size, GDFStatus.GDF_COLUMN_SIZE_MISMATCH)
    out = _CMP[op](a.data, b.data).astype(jnp.int8)
    return Column(data=out, valid=_binary_valid(a, b),
                  info=DtypeInfo(GDFDtype.INT8), name=a.name)
