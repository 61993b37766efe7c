"""Device mesh helpers.

The reference's only scale-out story is docker-compose ``replicas`` — full
index copies with no sharding (README.md:123-126, docker-compose.yml:48-50).
Here scale-out is true sharding over a ``jax.sharding.Mesh``: the corpus
(embedding table + neighbor tables + inverted lists) splits by row across
the ``shard`` axis, per-shard search runs SPMD under ``shard_map``, and
results merge with XLA collectives (``all_gather`` + top-k), not HTTP.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

SHARD_AXIS = "shard"
SLICE_AXIS = "slice"


def shard_axis() -> str:
    return SHARD_AXIS


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all visible devices)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"Requested {n_devices} devices, only {len(devices)} visible"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (SHARD_AXIS,))


def make_mesh_2d(n_slices: int, shards_per_slice: int,
                 devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """2-D mesh ("slice", "shard"): devices grouped into slices.

    Sharded-search merges all_gather over the inner "shard" axis first
    (S_inner·B·k pairs per slice) and then only the per-slice winners —
    B·k pairs per slice — over the outer "slice" axis. On hosts this
    runs on virtual devices; pass a slice-ordered device list otherwise.
    """
    if devices is None:
        devices = jax.devices()
    need = n_slices * shards_per_slice
    if need > len(devices):
        raise ValueError(
            f"Requested {need} devices, only {len(devices)} visible"
        )
    grid = np.array(devices[:need]).reshape(n_slices, shards_per_slice)
    return Mesh(grid, (SLICE_AXIS, SHARD_AXIS))
