"""Multi-host initialization and frame assembly.

The reference is strictly single-process (SURVEY.md §2 checklist); the
scaling path beyond one host is ``jax.distributed`` + a global
mesh whose tile axis spans all processes. Pixels are independent, so the
only cross-host traffic is (a) the one-time scene broadcast implicit in
replicated arrays and (b) assembling the final frame on host 0 — the
psum merges stay inside a host (NVLink), the network between hosts only
sees display traffic.

This module is exercised in single-process mode by the test suite; the
multi-process paths follow the standard jax.distributed contract and are
gated on environment configuration (no cluster is assumed).
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .sharding import make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed when running multi-process.

    No-ops in single-process runs (the common case for tests and one-chip
    development). On clusters whose environment jax.distributed can
    read (for example SLURM), all arguments may be None and are
    auto-detected. Without such an environment, pass them explicitly.
    """
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address or num_processes:
        # Explicitly configured cluster: failures are real errors and
        # propagate — degrading to single-process here would silently
        # render 1/num_processes of the work.
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return
    # Auto-detect mode: on a supported cluster jax.distributed reads the
    # cluster environment itself. Outside a cluster detection fails —
    # that's the single-process case, which needs no initialization — but a cluster
    # that *was* detected and then failed to initialize must not be
    # swallowed into a silent single-process run.
    from ..utils.log import get_logger

    log = get_logger(__name__)
    try:
        jax.distributed.initialize()
    except RuntimeError as e:
        if "initialize" in str(e) and "already" in str(e):
            raise
        log.info(
            "no multi-process cluster detected (%s); running single-process",
            str(e).splitlines()[0],
        )
    except ValueError as e:
        # jax raises ValueError when cluster auto-detection finds nothing
        log.info(
            "no multi-process cluster detected (%s); running single-process",
            str(e).splitlines()[0],
        )


def global_mesh(spp_shards: int = 1):
    """Mesh over every device of every process (tiles x spp)."""
    return make_mesh(jax.devices(), spp_shards=spp_shards)


def gather_frame(accum: jax.Array, width: int, height: int) -> Optional[np.ndarray]:
    """Assemble the full [H*W, 3] accumulator on process 0.

    Uses jax.experimental.multihost_utils for cross-host gathers when
    running multi-process; single-process it is a plain device_get.
    Returns None on non-zero processes.
    """
    if jax.process_count() == 1:
        return np.asarray(accum)
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(accum, tiled=True)
    if jax.process_index() != 0:
        return None
    return np.asarray(gathered).reshape(height * width, 3)
