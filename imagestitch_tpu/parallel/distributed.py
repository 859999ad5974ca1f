"""Multi-host runtime bring-up.

The reference is strictly single-process (SURVEY §2.3).  This module owns the
multi-host runtime: ``jax.distributed.initialize`` bring-up, the global
(hosts x devices) mesh, host-sharded dataset ingestion (each host decodes
only its shard of the sequence), and `multihost_utils` synchronization;
XLA runs the collectives.

On a single host this degrades to the local mesh transparently, so the same
driver code runs from a laptop CPU to a multi-host cluster.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@dataclasses.dataclass
class RuntimeContext:
    mesh: Mesh
    process_index: int
    process_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               axis: str = "dp") -> RuntimeContext:
    """Bring up the distributed runtime and the global 1-D data mesh.

    With no arguments: auto-detect (cluster environment) when multiple processes
    are configured, else single-process local devices.
    """
    if coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    elif num_processes is not None and num_processes > 1:
        jax.distributed.initialize()
    devs = np.asarray(jax.devices())
    mesh = Mesh(devs, (axis,))
    return RuntimeContext(mesh=mesh,
                          process_index=jax.process_index(),
                          process_count=jax.process_count())


def host_shard(files: Sequence[str], ctx: RuntimeContext,
               overlap: int = 1) -> List[str]:
    """The slice of a sequential dataset THIS host should decode.

    Pair registration needs ``overlap`` trailing neighbor frames so pair
    (k, k+1) at a shard boundary is computable without cross-host image
    transfer — only the tiny offset records travel over DCN.
    """
    n = len(files)
    per = -(-n // ctx.process_count)
    s = ctx.process_index * per
    e = min(n, s + per + overlap)
    return list(files[s:e])


def make_global_batch(local_gray: np.ndarray, ctx: RuntimeContext,
                      axis: Optional[str] = None):
    """Assemble a process-local batch into one globally-sharded device array
    (jax.make_array_from_process_local_data)."""
    axis = axis or ctx.mesh.axis_names[0]
    sharding = NamedSharding(ctx.mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding, local_gray)


def all_gather_records(values: np.ndarray, ctx: RuntimeContext) -> np.ndarray:
    """Gather small per-pair record arrays from every host (DCN)."""
    if ctx.process_count == 1:
        return values
    from jax.experimental import multihost_utils
    return np.asarray(
        multihost_utils.process_allgather(values, tiled=True))
