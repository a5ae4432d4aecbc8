"""Device mesh + multi-host initialization.

The reference has no distributed backend at all (SURVEY.md §2/§5 —
its "communication" is application-level HTTP).  This module is the
rebuild's first-class replacement: a ("data", "model") mesh over the
devices' interconnect (NVLink within a host) with GSPMD shardings;
multi-host joins via ``jax.distributed.initialize``.

Axis roles:
  data  — query batches (DP) and training batches
  model — corpus rows (the "model" of a retrieval engine is the index),
          attention heads / FFN hidden (TP), experts (EP)
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from qrag_tpu.config import MeshConfig

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host (DCN) init — the rebuild's ``init()`` step
    (SURVEY.md §3.5).  No-op for single-process runs."""
    if coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    logger.info(
        "joined cluster: process %d/%d, %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.device_count(),
    )


def make_mesh(
    config: Optional[MeshConfig] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build the ("data", "model") mesh.

    data_parallel / model_parallel semantics: -1 means "all remaining
    devices on this axis"; both -1 puts everything on "model" (the
    retrieval-heavy default: corpus rows sharded, queries replicated).
    """
    config = config or MeshConfig()
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    dp, mp = config.data_parallel, config.model_parallel
    if dp == -1 and mp == -1:
        dp, mp = 1, n
    elif dp == -1:
        dp = n // mp
    elif mp == -1:
        mp = n // dp
    if dp * mp != n:
        raise ValueError(
            f"mesh {dp}x{mp} does not cover {n} devices"
        )
    arr = np.asarray(devices).reshape(dp, mp)
    return Mesh(arr, (config.data_axis, config.model_axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh) -> NamedSharding:
    """Shard a (N, d) matrix's rows across the model axis."""
    return NamedSharding(mesh, P(MODEL_AXIS, None))


def batch_sharded(mesh: Mesh) -> NamedSharding:
    """Shard a (B, ...) batch across the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))
