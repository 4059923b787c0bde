"""Data-parallel scale-out over a JAX device mesh.

The reference is strictly single-threaded, single-process (SURVEY §2.5) —
batch decoding downstream is a Python loop over utterances.  Here the
utterance batch is a first-class array axis, and scaling out is a sharding
annotation, not a code change: the per-frame step is already pure and
batch-independent, so partitioning the batch axis over a ``data`` mesh
axis makes XLA run every chip on its shard with zero collectives in the
hot loop (stats reductions stay per-utterance).

Multi-host: call :func:`initialize_distributed` first (wraps
``jax.distributed.initialize``), then build the mesh over all devices —
the same code path scales from one card to several hosts.  Tests exercise
this on a virtual 8-device CPU mesh (see tests/conftest.py); on GPUs,
``chip_smoke.py --chips 4`` checks it against a single-card decode.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(**kwargs) -> None:
    """Multi-host init (no-op if already initialized)."""
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        pass  # already initialized


def make_mesh(
    num_devices: Optional[int] = None, axis_name: str = "data"
) -> Mesh:
    """1-D data-parallel mesh over (the first ``num_devices``) devices."""
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> NamedSharding:
    """Shard the leading (batch) axis over the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_batch(
    scores: np.ndarray, lengths: np.ndarray, multiple: int
) -> tuple:
    """Pad the batch axis to a multiple of the mesh size with empty
    (length-0) utterances; returns (scores, lengths, original_B)."""
    B = scores.shape[0]
    Bp = ((B + multiple - 1) // multiple) * multiple
    if Bp == B:
        return scores, lengths, B
    scores_p = np.zeros((Bp,) + scores.shape[1:], scores.dtype)
    scores_p[:B] = scores
    lengths_p = np.zeros((Bp,), lengths.dtype)
    lengths_p[:B] = lengths
    return scores_p, lengths_p, B
