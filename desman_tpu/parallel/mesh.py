"""Device mesh construction and sharding specs.

The scaling design (SURVEY.md §2.2): two mesh axes —

- ``chain``: embarrassingly parallel replicates/seeds (the reference's
  shell-level ``for g; for r; desman &`` fan-out). Zero communication.
- ``data``: variant positions V sharded data-parallel. The tau sweep is
  position-independent given (gamma, eta); the gamma/eta MH steps and the
  log-likelihood need position-sum sufficient statistics, which XLA lowers
  to psums over this axis automatically because every reduction is an einsum
  over V (GSPMD inserts the collectives; nothing hand-written).

Multi-host: the same code runs under ``jax.distributed.initialize`` — the
mesh spans all processes' devices and the psums ride NVLink between the
GPUs of a host (all to all, so no placement rule applies) and the network
across hosts. The per-sweep collective payload is a few KB (gamma/eta
stats), so scaling efficiency stays near 1 (SURVEY.md §5).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAIN_AXIS = "chain"
DATA_AXIS = "data"


def make_mesh(
    n_chain: Optional[int] = None,
    n_data: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (chain, data) mesh over the available devices.

    Default split: all devices on the data (position) axis — positions are
    the scaling dimension (SURVEY.md §5 'long-context' analogue); pass
    n_chain > 1 to dedicate devices to replicate parallelism. A single
    process given both sizes uses its first n_chain * n_data devices.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_chain is None and n_data is None:
        n_chain, n_data = 1, n
    elif n_chain is None:
        n_chain = n // n_data
    elif n_data is None:
        n_data = n // n_chain
    elif n_chain * n_data < n and jax.process_count() == 1:
        devices = devices[:n_chain * n_data]
        n = len(devices)
    if n_chain * n_data != n:
        raise ValueError(f"mesh {n_chain}x{n_data} != {n} devices")
    arr = np.array(devices).reshape(n_chain, n_data)
    return Mesh(arr, (CHAIN_AXIS, DATA_AXIS))


def counts_spec() -> P:
    """n[V,S,4] sharded over positions, replicated across chains."""
    return P(DATA_AXIS, None, None)


def keys_spec() -> P:
    """Per-chain PRNG keys [C,2] sharded over the chain axis."""
    return P(CHAIN_AXIS)


def shard_counts(n, mesh: Mesh):
    return jax.device_put(n, NamedSharding(mesh, counts_spec()))


def shard_keys(keys, mesh: Mesh):
    return jax.device_put(keys, NamedSharding(mesh, keys_spec()))


def pad_positions(counts: np.ndarray, multiple: int):
    """Pad V up to a multiple of the data-axis size with zero-coverage rows.

    Zero-coverage rows contribute exactly 0 to every likelihood term
    (n * log p with n = 0), so padding is inference-neutral — masking, not
    dropping, keeps shapes static (SURVEY.md §7.3 'ragged reality').
    Returns (padded_counts, original_V).
    """
    V = counts.shape[0]
    Vp = ((V + multiple - 1) // multiple) * multiple
    if Vp == V:
        return counts, V
    pad = np.zeros((Vp - V,) + counts.shape[1:], counts.dtype)
    return np.concatenate([counts, pad], axis=0), V


def pad_tau(tau, multiple: int):
    """Pad a [V,G] tau (init/fixed haplotypes) to match pad_positions:
    padded rows have zero coverage, so their base (A) is inert."""
    if tau is None:
        return None
    tau = np.asarray(tau)
    padded, _ = pad_positions(tau, multiple)
    return padded
