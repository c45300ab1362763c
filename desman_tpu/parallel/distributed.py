"""Multi-host initialization (SURVEY.md §2.2 'Distributed comm backend').

The reference has no distributed backend — replicates are OS processes.
Here multi-host runs use ``jax.distributed``: every host calls
``maybe_initialize()`` (no-op single-host / already-initialized), builds the
same global (chain, data) mesh over all processes' devices, and executes the
identical program; XLA routes the per-sweep psums over NVLink between the
GPUs of a host and the network across hosts. The collective payload is a few KB of gamma/eta
sufficient statistics per sweep (SURVEY.md §5), so scaling efficiency is
expected near 1 — measured by bench.py's scaling mode when multi-host
hardware is available.
"""
from __future__ import annotations

import os
from typing import Optional

import jax


def maybe_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when a multi-host env is configured.

    Honors explicit args first, then the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or a
    cluster runtime that auto-configures). Returns True when running
    multi-host.
    """
    # Don't probe jax.process_count() here: it initializes the XLA backend,
    # after which jax.distributed.initialize() refuses to run. Check the
    # distributed client state directly instead.
    try:
        from jax._src.distributed import global_state as _dist_state
        already = _dist_state.client is not None
    except Exception:  # pragma: no cover - private-API fallback
        already = False
    if already:
        return jax.process_count() > 1
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr is None:
        return False
    kwargs = {"coordinator_address": addr}
    n = num_processes if num_processes is not None else os.environ.get(
        "JAX_NUM_PROCESSES")
    p = process_id if process_id is not None else os.environ.get(
        "JAX_PROCESS_ID")
    if n is not None:
        kwargs["num_processes"] = int(n)
    if p is not None:
        kwargs["process_id"] = int(p)
    # CPU multi-process needs a cross-host collectives backend; XLA's default
    # ("none") would deadlock the first psum. Gloo ships with jaxlib and is
    # what tests/test_multiprocess.py exercises; GPU runs ignore this knob.
    if os.environ.get("JAX_PLATFORMS", "") == "cpu" or (
            jax.config.jax_platforms == "cpu"):
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass
    jax.distributed.initialize(**kwargs)
    return jax.process_count() > 1


def is_coordinator() -> bool:
    """True on the process that should write outputs (rank 0)."""
    return jax.process_index() == 0
