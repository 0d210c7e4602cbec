"""libgdf_tpu — a vectorized query-execution engine written in JAX.

A from-scratch re-design (NOT a port) of the GPU DataFrame library
gpuopenanalytics/libgdf: Arrow-layout columnar tables as JAX pytrees,
operators as fused XLA programs, and a distributed
shuffle layer over `jax.sharding.Mesh` that the single-GPU reference never
had.

Layer map (≅ SURVEY.md §1):
  core/      Column/Table pytrees, dtypes, validity, errors  (≅ L5/L3)
  ops/       relational + elementwise operators              (≅ L4)
  parallel/  mesh, shuffle, distributed operators            (new)
  io/        CSV, Arrow IPC, CSR                             (≅ L4 io/)
  memory/    allocation statistics & event log               (≅ L1 RMM)
  compat/    the gdf_* flat-function ABI surface             (≅ L5/L6)
"""
import os

# int64/float64 are core dataframe dtypes (GDF_INT64/GDF_FLOAT64,
# types.h:15-29); JAX disables them by default. Opt out with
# LIBGDF_TPU_NO_X64=1 before import.
if not os.environ.get("LIBGDF_TPU_NO_X64"):
    import jax

    jax.config.update("jax_enable_x64", True)

from .core import (  # noqa: E402
    Column, Context, DtypeInfo, GDFDtype, GDFError, GDFStatus, Method,
    Table, TimeUnit, column_concat, table_concat,
)
from . import ops  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Column", "Table", "GDFDtype", "TimeUnit", "DtypeInfo",
    "GDFError", "GDFStatus", "Context", "Method",
    "column_concat", "table_concat", "ops",
]
