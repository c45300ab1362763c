"""Shared numeric utilities.

JAX re-expression of the helpers the reference keeps in
``desman/Desman_Utils.py`` (log-multinomial pmf, guarded elementwise ops,
one-hot tau expansion, permutation-matched SNP distance) — see SURVEY.md §2.
Everything device-side is pure JAX; the permutation matcher runs on host
(scipy Hungarian) because it is a tiny O(G^3) problem executed once per
comparison, not per sweep.
"""
from __future__ import annotations

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np

# Base alphabet order used throughout (matches DESMAN CSV column order).
BASES = ("A", "C", "G", "T")
NBASES = 4

# Floor used inside logs to keep gradients/values finite. p entries are
# probabilities; 1e-12 is far below any reachable probability at f32.
_LOG_FLOOR = 1e-12


_REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compilation_cache_dir() -> str:
    """Where compiled executables persist: ``JAX_COMPILATION_CACHE_DIR`` when
    it is set, else the fixed ``.jax_cache/`` directory of the checkout (a
    fixed path: the cache key includes it, so a moving directory never
    hits)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO_DIR, ".jax_cache"))


def enable_compilation_cache() -> None:
    """Persistent XLA executable cache (big-V/G-grid compiles take minutes;
    cached re-runs are near-instant). Safe no-op on failure; opt out with
    DESMAN_TPU_NO_CACHE=1. Shared by the CLI, benchmarks and examples."""
    if os.environ.get("DESMAN_TPU_NO_CACHE"):
        return
    try:
        cache_dir = compilation_cache_dir()
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass  # cache is an optimization; never block the run on it


def heinsum(subscripts: str, *operands, **kwargs) -> jax.Array:
    """einsum pinned to full-f32 accumulation.

    On the GPU an f32 contraction without a precision may run on the
    tensor cores in TF32 (about three decimal digits); the likelihood /
    MH-acceptance sums need true f32 (deviance drives model selection —
    SURVEY.md §7.3 'f32 vs f64'). All contractions here have tiny inner
    dims (4 or G), so they are bandwidth-bound and HIGHEST costs nothing.
    """
    return jnp.einsum(
        subscripts, *operands, precision=jax.lax.Precision.HIGHEST, **kwargs
    )


def safe_log(x: jax.Array) -> jax.Array:
    """log with a floor: log(max(x, 1e-12)). Keeps -inf out of reductions."""
    return jnp.log(jnp.maximum(x, _LOG_FLOOR))


def log_multinomial_coeff(n: jax.Array, axis: int = -1) -> jax.Array:
    """log[ N! / prod_i n_i! ] with N = sum over `axis`.

    Uses lgamma so it vectorizes. n may be float or int.
    """
    n = n.astype(jnp.float32)
    total = jnp.sum(n, axis=axis)
    return jax.scipy.special.gammaln(total + 1.0) - jnp.sum(
        jax.scipy.special.gammaln(n + 1.0), axis=axis
    )


def one_hot_tau(tau_idx: jax.Array, dtype=jnp.float32) -> jax.Array:
    """Expand integer base calls [..., ] in 0..3 to one-hot [..., 4]."""
    return jax.nn.one_hot(tau_idx, NBASES, dtype=dtype)


def compress_tau(tau_onehot: jax.Array) -> jax.Array:
    """Collapse a one-hot (or probability) tau [..., 4] to argmax indices."""
    return jnp.argmax(tau_onehot, axis=-1).astype(jnp.int32)


def normalize_rows(x: jax.Array, axis: int = -1, eps: float = 1e-12) -> jax.Array:
    """Project onto the simplex along `axis` by dividing by the sum."""
    s = jnp.sum(x, axis=axis, keepdims=True)
    return x / jnp.maximum(s, eps)


def bh_fdr(pvalues: np.ndarray) -> np.ndarray:
    """Benjamini–Hochberg q-values (host-side; the filter's FDR step).

    Mirrors the reference filter's BH correction (SURVEY.md §3.2).
    """
    p = np.asarray(pvalues, dtype=np.float64)
    n = p.size
    order = np.argsort(p)
    ranked = p[order] * n / (np.arange(n) + 1.0)
    # enforce monotonicity from the largest rank down
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    q = np.empty_like(ranked)
    q[order] = np.clip(ranked, 0.0, 1.0)
    return q


def snp_distance_perm(
    tau_a: np.ndarray, tau_b: np.ndarray, return_perm: bool = False
):
    """Minimum SNP distance between two haplotype sets over strain permutations.

    tau_a: [V, Ga] integer base calls; tau_b: [V, Gb]. Strains of b are
    assigned to strains of a by the Hungarian algorithm on the pairwise
    SNP-count matrix (the reference's ``compSND``-style matcher / validateSNP
    semantics, SURVEY.md §2). Returns total mismatches over matched pairs
    (and the permutation of b's strains if requested). If Ga != Gb the
    unmatched surplus strains are ignored.
    """
    from scipy.optimize import linear_sum_assignment

    tau_a = np.asarray(tau_a)
    tau_b = np.asarray(tau_b)
    assert tau_a.shape[0] == tau_b.shape[0], "position axes must match"
    ga, gb = tau_a.shape[1], tau_b.shape[1]
    cost = np.zeros((ga, gb), dtype=np.int64)
    for i in range(ga):
        for j in range(gb):
            cost[i, j] = int(np.sum(tau_a[:, i] != tau_b[:, j]))
    rows, cols = linear_sum_assignment(cost)
    dist = int(cost[rows, cols].sum())
    if return_perm:
        return dist, (rows, cols)
    return dist


def match_gamma_perm(gamma_a: np.ndarray, gamma_b: np.ndarray):
    """Best-permutation mean absolute error between two gamma matrices [S,G].

    Used by validation to compare inferred abundances against ground truth
    irrespective of strain label order.
    """
    from scipy.optimize import linear_sum_assignment

    gamma_a = np.asarray(gamma_a, dtype=np.float64)
    gamma_b = np.asarray(gamma_b, dtype=np.float64)
    ga, gb = gamma_a.shape[1], gamma_b.shape[1]
    cost = np.zeros((ga, gb))
    for i in range(ga):
        for j in range(gb):
            cost[i, j] = np.abs(gamma_a[:, i] - gamma_b[:, j]).mean()
    rows, cols = linear_sum_assignment(cost)
    return float(cost[rows, cols].mean()), (rows, cols)


def all_base_pairs():
    """The 6 unordered distinct base pairs, used by the variant filter's H1."""
    return list(itertools.combinations(range(NBASES), 2))
