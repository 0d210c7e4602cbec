"""Device mesh helpers.

The reference is single-GPU, single-process (SURVEY.md §2.8: no NCCL/MPI/
UCX anywhere); its only provision for scale-out is gdf_hash_partition
(libgdf/src/hashing.cu:559-654) producing contiguous partitions for an
external driver to ship. This package supplies the missing distributed
runtime natively: a 1-D `jax.sharding.Mesh` of row shards, row-sharded
tables, and collective shuffles (parallel/shuffle.py).

The mesh is 1-D because it follows the algorithm, not the wiring: a hash
shuffle sends from every shard to every other, and NVLink joins the cards
of a host all to all. Across hosts the same jax.lax collectives run over
the network.
"""
from __future__ import annotations


import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DEFAULT_AXIS = "shards"


def make_mesh(num_devices: int | None = None,
              axis_name: str = DEFAULT_AXIS) -> Mesh:
    """1-D mesh over the first `num_devices` devices (default: all)."""
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host initialization (jax.distributed). No-op when single
    process. ≅ the runtime init the reference never had."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def row_sharding(mesh: Mesh, axis_name: str = DEFAULT_AXIS) -> NamedSharding:
    """Sharding that splits a column's row axis over the mesh."""
    return NamedSharding(mesh, P(axis_name))


def shard_table(table, mesh: Mesh, axis_name: str = DEFAULT_AXIS):
    """Place a (host-global) Table with rows sharded over the mesh.
    Row count must be divisible by the mesh size; pad first if not."""
    sharding = row_sharding(mesh, axis_name)
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), table)
