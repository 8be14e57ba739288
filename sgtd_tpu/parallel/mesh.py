"""Device-mesh helpers for sharded matching.

The reference has no distributed execution at all (SURVEY.md section 2.3);
this module defines the scaling axes that replace it:

  * ``db``   — descriptor-database rows sharded across devices (the map-size
               scaling axis; the analog of the reference's unbounded hash DB,
               STDesc.h:370, which caps at MAX_FRAME_N=20000 keyframes).
  * ``dp``   — data parallelism over query scans.

Collectives run under shard_map: per-shard votes are psum-merged, pair
lists all-gathered (queries are tiny compared to the DB).
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    dp: int = 1, db: int | None = None, devices: Sequence | None = None
) -> Mesh:
    """Create a (dp, db) mesh. ``db`` defaults to all remaining devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if db is None:
        if n % dp != 0:
            raise ValueError(f"{n} devices not divisible by dp={dp}")
        db = n // dp
    if dp * db > n:
        raise ValueError(f"mesh {dp}x{db} needs {dp*db} devices, have {n}")
    arr = np.asarray(devices[: dp * db]).reshape(dp, db)
    return Mesh(arr, ("dp", "db"))


def db_sharding(mesh: Mesh):
    """Shardings for a DescriptorDB pytree: rows on 'db', keyframes replicated."""
    from sgtd_tpu.db.database import DescriptorDB

    return DescriptorDB(
        keys=NamedSharding(mesh, P("db")),
        codes=NamedSharding(mesh, P("db")),
        packed2=NamedSharding(mesh, P("db", None)),
        vertices=NamedSharding(mesh, P("db", None, None)),
        frame_ids=NamedSharding(mesh, P("db")),
        cell_start=NamedSharding(mesh, P(None)),
        frame_rows=NamedSharding(mesh, P(None)),
        frame_start=NamedSharding(mesh, P(None)),
        frame_poses=NamedSharding(mesh, P(None, None, None)),
        frame_valid=NamedSharding(mesh, P(None)),
        bucket_table=NamedSharding(mesh, P(None)),
        cell_remap=NamedSharding(mesh, P(None)),
        code_remap=NamedSharding(mesh, P(None)),
        table_stride=NamedSharding(mesh, P(None)),
    )


def shard_database(db, mesh: Mesh):
    """Place a DescriptorDB on the mesh with rows sharded over 'db'.

    Rows are key-sorted globally, so each contiguous shard is locally sorted
    and per-shard searchsorted probes remain correct; buckets split across a
    shard boundary are scanned half on each side and their votes merge in the
    psum.
    """
    from sgtd_tpu.db.database import DescriptorDB

    n_db = mesh.shape["db"]
    m = db.keys.shape[0]
    if m % n_db != 0:
        raise ValueError(
            f"DB rows ({m}) must be divisible by db axis ({n_db}); "
            "build_database pads to a multiple of 128"
        )
    shardings = db_sharding(mesh)
    return DescriptorDB(
        *(
            jax.device_put(x, s)
            for x, s in zip(tuple(db), tuple(shardings))
        )
    )
