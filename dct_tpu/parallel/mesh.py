"""Device meshes for sharded encode/decode.

The reference has zero concurrency (SURVEY.md section 2, "parallelism:
ABSENT"); the codec's parallel axes on a device mesh are:

  * ``data``   — independent frames (the batch axis; the codec's DP)
  * ``stripe`` — tile stripes within a frame (spatial/context parallelism:
    8x8 blocks share no pixels, so stripes need NO halo exchange — only
    bitstream-offset metadata crosses chips, SURVEY.md section 5.7/5.8)

Multi-host initialization wraps jax.distributed; collectives (NCCL on
GPUs: NVLink within a host, the network across hosts) follow the mesh
axes as XLA lays them out. The mesh follows the algorithm alone — no
interconnect topology is assumed.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
STRIPE_AXIS = "stripe"


def make_mesh(
    n_data: int | None = None,
    n_stripe: int | None = None,
    devices=None,
) -> Mesh:
    """2D ('data', 'stripe') mesh over the given (default: all) devices.

    With only one axis size given, the other takes the remaining devices.
    Defaults to putting all devices on the stripe axis (single-stream
    encode, the BASELINE.json config-4 shape).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_data is None and n_stripe is None:
        n_data, n_stripe = 1, n
    elif n_data is None:
        n_data = n // n_stripe
    elif n_stripe is None:
        n_stripe = n // n_data
    if n_data * n_stripe != n:
        raise ValueError(
            f"mesh {n_data}x{n_stripe} != {n} devices"
        )
    arr = np.asarray(devices[: n_data * n_stripe]).reshape(n_data, n_stripe)
    return Mesh(arr, (DATA_AXIS, STRIPE_AXIS))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """(F, Hp, Wp) batch of frames: frames over data, rows over stripe."""
    return NamedSharding(mesh, P(DATA_AXIS, STRIPE_AXIS, None))


def stripes_sharding(mesh: Mesh) -> NamedSharding:
    """(F, n_stripes, ...) per-stripe outputs."""
    return NamedSharding(mesh, P(DATA_AXIS, STRIPE_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(**kwargs) -> None:
    """Multi-host entry: jax.distributed.initialize passthrough.

    Encode jobs are stateless and idempotent per stripe (SURVEY.md section
    5.3), so failure handling is retry-at-driver — no elastic state to
    rebuild beyond re-running the failed stripe set.
    """
    jax.distributed.initialize(**kwargs)
