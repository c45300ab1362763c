"""Multi-bin batched deconvolution: every MAG in one device program.

The reference processes one genome bin at a time (one OS process per
``desman`` run — SURVEY.md §3.5); a metagenome yields tens of bins that
share the same sample set, so on an accelerator the natural batching axis
is the bin:
pad each bin's variant positions to a common V (zero-count rows are
likelihood-neutral: n=0 kills every log term and the multinomial
coefficient) and vmap the whole chain over bins. One compile covers all
bins with the same G; per-bin results are sliced back out.

This is additional surface of this implementation, not reference parity — the
reference's equivalent is a shell loop over bins.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import io
from .sampler import SamplerConfig, SamplerResult, run_chain, tau_sweep_xla


def pad_bins(counts_list: Sequence[np.ndarray]) -> np.ndarray:
    """Stack [V_b, S, 4] tensors into [B, V_max, S, 4] with zero padding."""
    if not counts_list:
        raise ValueError("no bins")
    S = counts_list[0].shape[1]
    for c in counts_list:
        if c.ndim != 3 or c.shape[1] != S or c.shape[2] != 4:
            raise ValueError(
                "all bins must be [V, S, 4] with a shared sample axis; got "
                f"{[tuple(x.shape) for x in counts_list]}")
    v_max = max(c.shape[0] for c in counts_list)
    out = np.zeros((len(counts_list), v_max, S, 4), np.float32)
    for b, c in enumerate(counts_list):
        out[b, : c.shape[0]] = c
    return out


def run_bins(
    counts_list: Sequence[np.ndarray],
    cfg: SamplerConfig,
    seed: int = 0,
    eta_init: Optional[np.ndarray] = None,
    tau_sweep=tau_sweep_xla,
) -> List[SamplerResult]:
    """Run one chain per bin, vmapped over bins; returns per-bin results
    with the padding stripped.

    Each bin gets its own fold_in-derived key, so results are identical to
    running the bins separately with those keys up to the neutral padded
    rows (which consume Gumbel draws positionally — per-bin trajectories
    are deterministic in (counts_list order, seed))."""
    padded = jnp.asarray(pad_bins(counts_list))
    B = padded.shape[0]
    keys = jax.vmap(lambda b: jax.random.fold_in(jax.random.PRNGKey(seed), b))(
        jnp.arange(B)
    )
    eta = None if eta_init is None else jnp.asarray(eta_init, jnp.float32)

    res = jax.vmap(
        lambda n, k: run_chain(n, cfg, k, eta_init=eta, tau_sweep=tau_sweep)
    )(padded, keys)

    out = []
    for b, c in enumerate(counts_list):
        V = c.shape[0]
        one = jax.tree_util.tree_map(lambda x: x[b], res)
        out.append(one._replace(tau_mean=one.tau_mean[:V],
                                tau_star=one.tau_star[:V]))
    return out


def run_bins_files(
    counts_files: Sequence[str],
    cfg: SamplerConfig,
    out_dirs: Sequence[str],
    seed: int = 0,
    eta_init: Optional[np.ndarray] = None,
    tau_sweep=tau_sweep_xla,
) -> List[SamplerResult]:
    """File-level wrapper: read counts CSVs, run, write one DESMAN-format
    output dir per bin."""
    from .run import write_outputs

    if len(set(out_dirs)) != len(out_dirs):
        raise ValueError(f"duplicate output dirs: {sorted(out_dirs)}")
    datas = [io.read_counts_csv(f) for f in counts_files]
    samples0 = datas[0].samples
    for f, d in zip(counts_files, datas):
        if d.samples != samples0:
            raise ValueError(
                f"{f}: sample columns differ from {counts_files[0]} — "
                "multi-bin batching requires a shared sample set")
    results = run_bins([d.counts for d in datas], cfg, seed=seed,
                       eta_init=eta_init, tau_sweep=tau_sweep)
    for d, r, out_dir in zip(datas, results, out_dirs):
        write_outputs(out_dir, d, r, cfg)
    return results
