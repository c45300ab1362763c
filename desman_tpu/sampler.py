"""The tau/gamma/eta Gibbs sampler as a pure-functional jitted scan.

Accelerator-first redesign of the reference's ``desman/HaploSNP_Sampler.py`` +
``desman/sampletau.pyx`` Cython/GSL hot loop (SURVEY.md §2, §3.1). Instead of
a Python object mutating arrays in place with a GSL RNG stream, the sampler is
``state -> state``: one sweep =

  1. **tau update** — exact Gibbs. For strain g (sequential over g, the
     conditional coupling the reference also respects — SURVEY.md §7.3), all V
     positions in parallel: subtract strain g from the cached true-base
     mixture M[v,s,a], evaluate the 4 candidate-base conditional log-likelihoods
     as one fused elementwise+reduction (O(V*S*16)), and draw categoricals via
     the Gumbel-argmax trick with counter-based `jax.random` keys.
  2. **gamma update** — MH-within-Gibbs with a Dirichlet(kappa*gamma) random
     walk proposal, all S samples proposed and accepted *in parallel* (valid:
     the likelihood factorizes over samples given tau, eta).
  3. **eta update** — per-row Dirichlet MH against the full likelihood with a
     diagonal-concentrated Dirichlet prior (skipped when eta is fixed from the
     filter's tran_df, the reference's ``desman -e`` mode).

The whole run is one ``lax.scan`` over sweeps carrying posterior-mean
accumulators and the max-likelihood "star" snapshot (the reference's
``*_star`` ICM aspect). Every reduction over the position axis V is an einsum,
so under a position-sharded mesh XLA turns them into psums (desman_tpu.parallel).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .likelihood import mixture
from .nmf import nmf_init
from .utils import NBASES, heinsum, log_multinomial_coeff, one_hot_tau, safe_log

_GAMMA_FLOOR = 1e-10


@dataclass(frozen=True)
class SamplerConfig:
    """Static hyperparameters (hashable → usable as a jit static arg).

    Mirrors the reference CLI's knobs: G (-g), burn+samples (-i), fix_eta
    (-e + fixed), seeds handled by the caller (-s). kappa_* are the MH
    proposal concentrations (SURVEY.md §0.1 gamma/eta updates).
    """

    G: int
    burn: int = 100
    samples: int = 100
    # MH proposal concentrations. 0.0 (default) = warm-start from the data's
    # posterior curvature at init (VERDICT r4 weak #1): kappa_gamma =
    # (n.sum()/S) / 32 and kappa_eta = n.sum(). The gamma-row conditional
    # concentrates AT MOST like a Dirichlet with total ~ the per-sample read
    # count N_s; the /32 reflects the measured posterior width (eta-blur +
    # cross-position overdispersion make it ~5x wider than the N_s bound:
    # acceptance at N_s/32 lands 0.15-0.30 across TestData, V=1500xS=48 and
    # V=4000xS=32 scales, where N_s itself gives ~0.4 but random-walk steps
    # too small to finish burn-in travel — measured gamma-MAE optimum is at
    # the /32-/64 start on every config tried). Burn-gated adaptation then
    # only fine-tunes ~1 decade, instead of climbing 3-4 decades from the
    # fixed 100/1000 start — which it cannot do at published-problem scale
    # (gamma acceptance was 0.03-0.10, eta ~0.01, on the S=64 x 7e3-SNV
    # mock). Explicit positive values pin the start exactly as before.
    kappa_gamma: float = 0.0
    kappa_eta: float = 0.0
    adapt_kappa: bool = True      # tune proposal scales during burn-in
    target_accept: float = 0.3
    adapt_rate: float = 0.15
    proposal_floor: float = 0.1
    eta_prior_diag: float = 10.0
    eta_prior_off: float = 1.0
    fix_eta: bool = False
    # "joint" (1 blocked MH on the whole 4x4, default: one likelihood pass /
    # one psum per sweep instead of four, the preferred mesh mode,
    # docs/SCALING.md) | "rows" (4 sequential per-row MH — the
    # reference's update shape, SURVEY.md §0.1 [M]; same stationary dist.)
    eta_update: str = "joint"
    fix_gamma: bool = False       # freeze abundances (known mixtures / tests)
    fix_tau: bool = False         # reference -f: freeze haplotypes, fit gamma/eta
    store_samples: bool = False   # keep post-burn (tau,gamma,eta) draws
    store_thin: int = 1           # keep every k-th post-burn draw (must divide samples)
    swap_moves: bool = True       # per-position strain-pair swap MH each sweep
    anneal_temp0: float = 3.0     # tempered tau updates early in burn-in
    anneal_frac: float = 0.5      # fraction of burn spent annealing T0 -> 1
    nmf_iters: int = 300

    @property
    def total_sweeps(self) -> int:
        return self.burn + self.samples


class SamplerState(NamedTuple):
    """Per-chain carry. mix caches M[v,s,a] = sum_g gamma[s,g] tau[v,g,a]."""

    tau: jax.Array      # int32 [V,G]
    gamma: jax.Array    # f32 [S,G]
    eta: jax.Array      # f32 [4,4]
    mix: jax.Array      # f32 [V,S,4]
    loglik: jax.Array   # f32 scalar (no multinomial coeff)
    key: jax.Array
    kappa_gamma: jax.Array  # f32 — adaptive proposal concentration
    kappa_eta: jax.Array


class SamplerAccum(NamedTuple):
    sum_tau: jax.Array      # f32 [V,G,4]
    sum_gamma: jax.Array    # f32 [S,G]
    sum_eta: jax.Array      # f32 [4,4]
    sum_loglik: jax.Array   # f32
    n_samples: jax.Array    # f32
    star_loglik: jax.Array  # f32
    star_tau: jax.Array     # int32 [V,G]
    star_gamma: jax.Array   # f32 [S,G]
    star_eta: jax.Array     # f32 [4,4]
    acc_gamma: jax.Array    # f32 — summed acceptance fraction (all sweeps)
    acc_eta: jax.Array      # f32
    acc_gamma_post: jax.Array  # f32 — summed acceptance, post-burn only
    acc_eta_post: jax.Array


class SamplerResult(NamedTuple):
    tau_mean: jax.Array     # [V,G,4] posterior base probabilities
    tau_star: jax.Array     # [V,G] int
    gamma_mean: jax.Array
    gamma_star: jax.Array
    eta_mean: jax.Array
    eta_star: jax.Array
    mean_loglik: jax.Array  # posterior mean loglik (no coeff)
    star_loglik: jax.Array
    loglik_trace: jax.Array  # [total_sweeps]
    accept_gamma: jax.Array  # mean acceptance rate over ALL sweeps
    accept_eta: jax.Array
    # post-burn (sampling-phase) acceptance — the number MC efficiency
    # depends on; the all-sweeps rate above averages over the adapting burn
    accept_gamma_post: Optional[jax.Array] = None
    accept_eta_post: Optional[jax.Array] = None
    # optional post-burn posterior draws (store_samples=True, thinned by
    # store_thin — SURVEY.md §0.1 'store every sample (or thinned)'), else None:
    tau_samples: Optional[jax.Array] = None    # int8 [samples/thin,V,G]
    gamma_samples: Optional[jax.Array] = None  # [samples/thin,S,G]
    eta_samples: Optional[jax.Array] = None    # [samples/thin,4,4]
    # replica exchange only (run_chain_pt): mean adjacent-swap acceptance
    pt_swap_accept: Optional[jax.Array] = None


def _dirichlet_logpdf(x, alpha):
    """Row-wise Dirichlet log-density; x, alpha [..., K] -> [...]."""
    return (
        jnp.sum((alpha - 1.0) * safe_log(x), axis=-1)
        + jax.scipy.special.gammaln(jnp.sum(alpha, axis=-1))
        - jnp.sum(jax.scipy.special.gammaln(alpha), axis=-1)
    )


def _sample_dirichlet(key, alpha):
    """Dirichlet draw via normalized Gammas, floored away from the boundary."""
    g = jax.random.gamma(key, alpha)
    g = jnp.maximum(g, _GAMMA_FLOOR)
    return g / jnp.sum(g, axis=-1, keepdims=True)


def _loglik(n, mix, eta):
    """sum n * log(mix @ eta) — fused by XLA into one reduction."""
    p = heinsum("vsa,ab->vsb", mix, eta)
    return jnp.sum(n * safe_log(p))


# --------------------------------------------------------------------------
# tau sweep (the reference's Cython+GSL hot loop, SURVEY.md §3.1)
# --------------------------------------------------------------------------

def tau_sweep_xla(n, tau, mix, gamma, eta, key, temp=1.0):
    """One full-Gibbs sweep over strains; all positions vectorized.

    Sequential fori_loop over g (G is small and the strain conditionals are
    coupled); per strain one fused O(V*S*16) candidate evaluation and a
    Gumbel-argmax categorical draw per position. temp > 1 tempers the
    conditional (argmax(cand + temp*gumbel) == sampling from p^(1/temp)),
    used by annealed maximization modes to escape single-site local optima.
    """
    G = tau.shape[1]
    V = tau.shape[0]

    def body(g, carry):
        tau, mix = carry
        gamma_g = jax.lax.dynamic_slice_in_dim(gamma, g, 1, axis=1)[:, 0]  # [S]
        tau_g = jax.lax.dynamic_slice_in_dim(tau, g, 1, axis=1)[:, 0]      # [V]
        oh = one_hot_tau(tau_g)                                            # [V,4]
        # remove strain g from the mixture
        rest = mix - gamma_g[None, :, None] * oh[:, None, :]               # [V,S,4]
        q = heinsum("vsa,ab->vsb", rest, eta)                           # [V,S,4]
        # candidate c adds gamma[s,g] * eta[c,b]:
        # cand[v,c] = sum_{s,b} n[v,s,b] * log(q[v,s,b] + gamma[s,g] eta[c,b])
        terms = safe_log(
            q[:, :, None, :] + gamma_g[None, :, None, None] * eta[None, None, :, :]
        )                                                                  # [V,S,C,B]
        cand = heinsum("vsb,vscb->vc", n, terms)                        # [V,4]
        gz = jax.random.gumbel(jax.random.fold_in(key, g), (V, NBASES))
        new_g = jnp.argmax(cand + temp * gz, axis=1).astype(jnp.int32)
        mix = rest + gamma_g[None, :, None] * one_hot_tau(new_g)[:, None, :]
        tau = jax.lax.dynamic_update_slice_in_dim(tau, new_g[:, None], g, axis=1)
        return tau, mix

    return jax.lax.fori_loop(0, G, body, (tau, mix))


def tau_swap_move(n, tau, mix, gamma, eta, key, beta=1.0):
    """Per-position pairwise swap move: propose exchanging strains (g, h)'s
    bases at every position, accept by per-position MH (positions are
    independent given gamma/eta; the proposal is symmetric). beta tempers
    the likelihood (replica exchange, run_chain_pt).

    Single-site Gibbs cannot cross between the 'label-swapped' modes of a
    position's joint posterior when the intermediate states are unlikely
    (a mixing flaw the reference's per-site sampler shares); one random pair
    per sweep costs ~2 of the sweep's 16G log-evaluations per position and
    restores mixing across labelings (tests/test_exactness.py).
    """
    G = tau.shape[1]
    V, S, _ = n.shape
    k_pair, k_u = jax.random.split(key)
    # random unordered pair g != h
    g = jax.random.randint(k_pair, (), 0, G)
    off = jax.random.randint(jax.random.fold_in(k_pair, 1), (), 1, G)
    h = (g + off) % G

    tau_g = jnp.take_along_axis(tau, jnp.full((V, 1), g), axis=1)[:, 0]
    tau_h = jnp.take_along_axis(tau, jnp.full((V, 1), h), axis=1)[:, 0]
    oh_g = one_hot_tau(tau_g)                              # [V,4]
    oh_h = one_hot_tau(tau_h)
    gam_g = jnp.take(gamma, g, axis=1)                     # [S]
    gam_h = jnp.take(gamma, h, axis=1)

    # The swap proposal is rank-1 in the mixture: mix_prop = mix + dgam[s] *
    # doh[v,a], so p_prop = p + dgam[s] * w[v,b] with w = doh @ eta — the MH
    # log-ratio is ONE fused pass of sum_sb n * (log p_prop - log p) with
    # per-element correlated rounding (each term is a difference of logs of
    # nearby values, so f32 noise on the ratio is ~1e-3 nats instead of the
    # difference-of-two-big-sums noise), and mix_prop is never materialized.
    dgam = gam_g - gam_h                                   # [S]
    doh = oh_h - oh_g                                      # [V,4]
    w = heinsum("va,ab->vb", doh, eta)                     # [V,4]
    p = heinsum("vsa,ab->vsb", mix, eta)                   # [V,S,4]
    p_prop = p + dgam[None, :, None] * w[:, None, :]
    dll = heinsum("vsb->v", n * (safe_log(p_prop) - safe_log(p)))
    accept = safe_log(jax.random.uniform(k_u, (V,))) < beta * dll

    new_tau_g = jnp.where(accept, tau_h, tau_g)
    new_tau_h = jnp.where(accept, tau_g, tau_h)
    tau = _set_col(tau, g, new_tau_g)
    tau = _set_col(tau, h, new_tau_h)
    mix = mix + jnp.where(accept, 1.0, 0.0)[:, None, None] * (
        dgam[None, :, None] * doh[:, None, :]
    )
    return tau, mix


def _set_col(x, j, col):
    """x[:, j] = col with a traced column index."""
    V, G = x.shape
    cols = jax.lax.broadcasted_iota(jnp.int32, (V, G), 1)
    return jnp.where(cols == j, col[:, None], x)


# --------------------------------------------------------------------------
# gamma / eta MH updates
# --------------------------------------------------------------------------

def gamma_step(cfg: SamplerConfig, n, tau, mix, gamma, eta, key, kappa=None,
               beta=1.0):
    """Parallel per-sample Dirichlet-random-walk MH (SURVEY.md §0.1).

    beta < 1 tempers the likelihood term only (prior/proposal corrections
    untempered) — the replica-exchange target pi_beta = prior * L^beta.

    Returns (gamma, mix, accept_rate, loglik): the per-sample old/new
    likelihood terms the MH ratio needs already determine the post-update
    total loglik (sum of the accepted branch per sample), so the sweep gets
    it for free — one fewer full [V,S,4] pass, and under a position-sharded
    mesh the old/new reductions ride ONE [2,S] psum instead of two.
    """
    if kappa is None:
        # direct callers without an adapted kappa: cfg 0.0 means auto, which
        # only init_state can resolve — fall back to the classic fixed scale
        kappa = cfg.kappa_gamma if cfg.kappa_gamma > 0 else 100.0
    k_prop, k_u = jax.random.split(key)
    alpha_fwd = kappa * gamma + cfg.proposal_floor                    # [S,G]
    gamma_prop = _sample_dirichlet(k_prop, alpha_fwd)
    alpha_rev = kappa * gamma_prop + cfg.proposal_floor

    tau_oh = one_hot_tau(tau)                                         # [V,G,4]
    mix_prop = mixture(tau_oh, gamma_prop)                            # [V,S,4]

    both = jnp.stack([mix, mix_prop])                                 # [2,V,S,4]
    ll = heinsum(
        "kvsb->ks", n[None] * safe_log(heinsum("kvsa,ab->kvsb", both, eta))
    )
    ll_old, ll_new = ll[0], ll[1]
    # symmetric Dirichlet(1) prior on gamma rows -> prior ratio = 0
    log_ratio = (
        beta * (ll_new - ll_old)
        + _dirichlet_logpdf(gamma, alpha_rev)
        - _dirichlet_logpdf(gamma_prop, alpha_fwd)
    )
    accept = safe_log(jax.random.uniform(k_u, (gamma.shape[0],))) < log_ratio
    gamma = jnp.where(accept[:, None], gamma_prop, gamma)
    mix = jnp.where(accept[None, :, None], mix_prop, mix)
    loglik = jnp.sum(jnp.where(accept, ll_new, ll_old))
    return gamma, mix, jnp.mean(accept.astype(jnp.float32)), loglik


def eta_step(cfg: SamplerConfig, n, mix, eta, loglik, key, kappa=None,
             beta=1.0):
    """Sequential per-row Dirichlet MH on the 4x4 error matrix.

    beta tempers the likelihood term only; the carried/returned loglik is
    always the untempered one (star tracking and replica exchange use it).
    """
    if kappa is None:
        kappa = cfg.kappa_eta if cfg.kappa_eta > 0 else 1000.0
    prior_alpha = (
        jnp.full((NBASES, NBASES), cfg.eta_prior_off)
        + jnp.eye(NBASES) * (cfg.eta_prior_diag - cfg.eta_prior_off)
    )

    def body(a, carry):
        eta, loglik, n_acc = carry
        ka = jax.random.fold_in(key, a)
        k_prop, k_u = jax.random.split(ka)
        row = jax.lax.dynamic_slice_in_dim(eta, a, 1, axis=0)[0]      # [4]
        alpha_fwd = kappa * row + cfg.proposal_floor
        row_prop = _sample_dirichlet(k_prop, alpha_fwd)
        alpha_rev = kappa * row_prop + cfg.proposal_floor
        eta_prop = jax.lax.dynamic_update_slice_in_dim(
            eta, row_prop[None, :], a, axis=0
        )
        ll_new = _loglik(n, mix, eta_prop)
        prior_row = jax.lax.dynamic_slice_in_dim(prior_alpha, a, 1, axis=0)[0]
        log_ratio = (
            beta * (ll_new - loglik)
            + jnp.sum((prior_row - 1.0) * (safe_log(row_prop) - safe_log(row)))
            + _dirichlet_logpdf(row, alpha_rev)
            - _dirichlet_logpdf(row_prop, alpha_fwd)
        )
        accept = safe_log(jax.random.uniform(k_u, ())) < log_ratio
        eta = jnp.where(accept, eta_prop, eta)
        loglik = jnp.where(accept, ll_new, loglik)
        return eta, loglik, n_acc + accept.astype(jnp.float32)

    eta, loglik, n_acc = jax.lax.fori_loop(
        0, NBASES, body, (eta, loglik, jnp.float32(0.0))
    )
    return eta, loglik, n_acc / NBASES


def eta_step_joint(cfg: SamplerConfig, n, mix, eta, loglik, key, kappa=None,
                   beta=1.0):
    """Blocked MH on the whole 4x4 error matrix: all four rows proposed at
    once, one joint accept/reject.

    Same stationary distribution as the per-row sweep (a valid MH kernel on
    the full eta block), but ONE likelihood evaluation per sweep instead of
    four — under a position-sharded mesh that is one scalar psum instead of
    four, which dominates per-sweep latency once V/device is small
    (docs/SCALING.md). The joint acceptance rate is lower at equal kappa;
    the adaptive controller simply settles on a larger kappa (smaller
    steps). Select with SamplerConfig.eta_update="joint".
    """
    if kappa is None:
        kappa = cfg.kappa_eta if cfg.kappa_eta > 0 else 1000.0
    prior_alpha = (
        jnp.full((NBASES, NBASES), cfg.eta_prior_off)
        + jnp.eye(NBASES) * (cfg.eta_prior_diag - cfg.eta_prior_off)
    )
    k_prop, k_u = jax.random.split(key)
    alpha_fwd = kappa * eta + cfg.proposal_floor                   # [4,4]
    eta_prop = _sample_dirichlet(k_prop, alpha_fwd)
    alpha_rev = kappa * eta_prop + cfg.proposal_floor
    ll_new = _loglik(n, mix, eta_prop)
    log_ratio = (
        beta * (ll_new - loglik)
        + jnp.sum((prior_alpha - 1.0) * (safe_log(eta_prop) - safe_log(eta)))
        + jnp.sum(_dirichlet_logpdf(eta, alpha_rev))
        - jnp.sum(_dirichlet_logpdf(eta_prop, alpha_fwd))
    )
    accept = safe_log(jax.random.uniform(k_u, ())) < log_ratio
    eta = jnp.where(accept, eta_prop, eta)
    loglik = jnp.where(accept, ll_new, loglik)
    return eta, loglik, accept.astype(jnp.float32)


# --------------------------------------------------------------------------
# full sweep + scan
# --------------------------------------------------------------------------

def _handles_swap(fn) -> bool:
    """True when the tau_sweep fn runs the swap move itself (the pallas
    kernel's epilogue) — looks through functools.partial (.func) and
    functools.wraps (.__wrapped__) wrappers, bounded against cycles."""
    for _ in range(16):
        if fn is None:
            return False
        if getattr(fn, "handles_swap", False):
            return True
        fn = getattr(fn, "func", None) or getattr(fn, "__wrapped__", None)
    return False


def make_sweep_fn(cfg: SamplerConfig, tau_sweep=tau_sweep_xla):
    """Build the (state, accum, sweep_idx) -> (state, accum, loglik) step.

    Optional trailing args: ``temp`` overrides the annealing schedule with a
    fixed tau-tempering temperature and ``beta`` tempers every MH acceptance
    (likelihood term only) — together they make the sweep target
    pi_beta = prior * L^beta, the per-replica kernel of run_chain_pt
    (pass temp = 1/beta for a consistent tempered target). ``burn``
    overrides cfg.burn for the sample-accumulation and adaptation gates with
    a TRACED value (converge.run_chain_auto decides burn at runtime without
    recompiling); the anneal schedule always follows the static cfg.burn.
    """

    def sweep(n, state: SamplerState, accum: SamplerAccum, it,
              temp=None, beta=1.0, burn=None):
        key = jax.random.fold_in(state.key, it)
        k_tau, k_gamma, k_eta = jax.random.split(key, 3)

        if cfg.fix_tau:
            tau, mix = state.tau, state.mix
        else:
            # tempered burn-in: sample tau from p^(1/T) with T annealing
            # T0 -> 1 over the first anneal_frac of burn, escaping the
            # local optima that stall low-abundance strains (post-anneal
            # sweeps are exact Gibbs, so the posterior is untouched)
            if temp is None:
                if cfg.anneal_temp0 > 1.0 and cfg.burn > 0:
                    anneal_sweeps = max(int(cfg.burn * cfg.anneal_frac), 1)
                    temp = jnp.maximum(
                        1.0,
                        jnp.float32(cfg.anneal_temp0)
                        ** (1.0 - it.astype(jnp.float32) / anneal_sweeps),
                    )
                else:
                    temp = 1.0
            do_swap = cfg.swap_moves and cfg.G > 1
            if do_swap and _handles_swap(tau_sweep):
                # fused path: the swap runs as the kernel's epilogue on its
                # register-resident block (ops/tau_pallas) — same proposal
                # stream and MH rule as tau_swap_move, minus its
                # device-memory round trips
                tau, mix = tau_sweep(
                    n, state.tau, state.mix, state.gamma, state.eta, k_tau,
                    temp=temp, swap_key=jax.random.fold_in(k_tau, 12345),
                    swap_beta=beta,
                )
            else:
                tau, mix = tau_sweep(
                    n, state.tau, state.mix, state.gamma, state.eta, k_tau,
                    temp=temp,
                )
                if do_swap:
                    tau, mix = tau_swap_move(
                        n, tau, mix, state.gamma, state.eta,
                        jax.random.fold_in(k_tau, 12345), beta=beta,
                    )
        if cfg.fix_gamma:
            gamma, acc_g = state.gamma, jnp.float32(0.0)
            loglik = _loglik(n, mix, state.eta)
        else:
            # loglik comes out of the MH step's own per-sample terms — no
            # separate full-likelihood pass (and no extra psum under a mesh)
            gamma, mix, acc_g, loglik = gamma_step(
                cfg, n, tau, mix, state.gamma, state.eta, k_gamma,
                kappa=state.kappa_gamma, beta=beta,
            )
        if cfg.fix_eta:
            eta, acc_e = state.eta, jnp.float32(0.0)
        else:
            eta_fn = eta_step_joint if cfg.eta_update == "joint" else eta_step
            eta, loglik, acc_e = eta_fn(
                cfg, n, mix, state.eta, loglik, k_eta,
                kappa=state.kappa_eta, beta=beta,
            )

        # diminishing adaptation, burn-in only: larger kappa -> smaller
        # Dirichlet steps -> higher acceptance, so push kappa toward the
        # target rate while burn lasts (valid MCMC: frozen post-burn)
        if cfg.adapt_kappa:
            adapting = (it < (cfg.burn if burn is None else burn)).astype(jnp.float32)
            kg = state.kappa_gamma * jnp.exp(
                adapting * cfg.adapt_rate * (cfg.target_accept - acc_g)
            )
            ke = state.kappa_eta * jnp.exp(
                adapting * cfg.adapt_rate * (cfg.target_accept - acc_e)
            )
            # wide ceilings: the curvature warm start already lands kappa
            # near the read-total scale (1e7+ on published-size data), so a
            # low clip would re-introduce the under-adaptation it fixes
            kg = jnp.clip(kg, 10.0, 1e9)
            ke = jnp.clip(ke, 10.0, 1e10)
        else:
            kg, ke = state.kappa_gamma, state.kappa_eta

        new_state = SamplerState(
            tau=tau, gamma=gamma, eta=eta, mix=mix, loglik=loglik,
            key=state.key, kappa_gamma=kg, kappa_eta=ke,
        )

        is_sample = (it >= (cfg.burn if burn is None else burn)).astype(jnp.float32)
        is_star = loglik > accum.star_loglik
        accum = SamplerAccum(
            sum_tau=accum.sum_tau + is_sample * one_hot_tau(tau),
            sum_gamma=accum.sum_gamma + is_sample * gamma,
            sum_eta=accum.sum_eta + is_sample * eta,
            sum_loglik=accum.sum_loglik + is_sample * loglik,
            n_samples=accum.n_samples + is_sample,
            star_loglik=jnp.where(is_star, loglik, accum.star_loglik),
            star_tau=jnp.where(is_star, tau, accum.star_tau),
            star_gamma=jnp.where(is_star, gamma, accum.star_gamma),
            star_eta=jnp.where(is_star, eta, accum.star_eta),
            acc_gamma=accum.acc_gamma + acc_g,
            acc_eta=accum.acc_eta + acc_e,
            acc_gamma_post=accum.acc_gamma_post + is_sample * acc_g,
            acc_eta_post=accum.acc_eta_post + is_sample * acc_e,
        )
        return new_state, accum, loglik

    return sweep


def init_state(
    n: jax.Array,
    cfg: SamplerConfig,
    key: jax.Array,
    eta_init: Optional[jax.Array] = None,
    tau_init: Optional[jax.Array] = None,
    gamma_init: Optional[jax.Array] = None,
) -> SamplerState:
    """NMF-initialized (or user-supplied) chain state. Jit-safe."""
    k_nmf, k_run = jax.random.split(key)
    if eta_init is None:
        eta = jnp.full((NBASES, NBASES), 0.01 / 3.0) + jnp.eye(NBASES) * (0.99 - 0.01 / 3.0)
    else:
        eta = jnp.asarray(eta_init, jnp.float32)
    if tau_init is not None and gamma_init is None:
        # known haplotypes (-t/-f): per-sample ML abundances by EM beat the
        # generic NMF start by an order of magnitude (nmf.em_gamma)
        from .nmf import em_gamma

        tau, gamma = tau_init, em_gamma(n, tau_init, eta)
    elif tau_init is None or gamma_init is None:
        tau_nmf, gamma_nmf = nmf_init(n, cfg.G, k_nmf, iters=cfg.nmf_iters)
        tau = tau_nmf if tau_init is None else tau_init
        gamma = gamma_nmf if gamma_init is None else gamma_init
    else:
        tau, gamma = tau_init, gamma_init
    mix = mixture(one_hot_tau(tau), gamma)
    loglik = _loglik(n, mix, eta)
    # curvature warm start (see SamplerConfig.kappa_* notes); floored at the
    # old fixed defaults so tiny/synthetic datasets keep usable step sizes
    if cfg.kappa_gamma > 0:
        kg0 = jnp.float32(cfg.kappa_gamma)
    else:
        kg0 = jnp.maximum(jnp.sum(n) / n.shape[1] / 32.0,
                          100.0).astype(jnp.float32)
    if cfg.kappa_eta > 0:
        ke0 = jnp.float32(cfg.kappa_eta)
    else:
        ke0 = jnp.maximum(jnp.sum(n), 1000.0).astype(jnp.float32)
    return SamplerState(
        tau=tau.astype(jnp.int32), gamma=gamma.astype(jnp.float32),
        eta=eta, mix=mix, loglik=loglik, key=k_run,
        kappa_gamma=kg0, kappa_eta=ke0,
    )


def init_accum(V: int, S: int, G: int) -> SamplerAccum:
    return SamplerAccum(
        sum_tau=jnp.zeros((V, G, NBASES), jnp.float32),
        sum_gamma=jnp.zeros((S, G), jnp.float32),
        sum_eta=jnp.zeros((NBASES, NBASES), jnp.float32),
        sum_loglik=jnp.float32(0.0),
        n_samples=jnp.float32(0.0),
        star_loglik=jnp.float32(-jnp.inf),
        star_tau=jnp.zeros((V, G), jnp.int32),
        star_gamma=jnp.zeros((S, G), jnp.float32),
        star_eta=jnp.zeros((NBASES, NBASES), jnp.float32),
        acc_gamma=jnp.float32(0.0),
        acc_eta=jnp.float32(0.0),
        acc_gamma_post=jnp.float32(0.0),
        acc_eta_post=jnp.float32(0.0),
    )


def _result_from_accum(accum: SamplerAccum, cfg: SamplerConfig, trace,
                       **extra) -> SamplerResult:
    """Posterior means + star snapshot from a finished accumulator."""
    n_s = jnp.maximum(accum.n_samples, 1.0)
    return SamplerResult(
        tau_mean=accum.sum_tau / n_s,
        tau_star=accum.star_tau,
        gamma_mean=accum.sum_gamma / n_s,
        gamma_star=accum.star_gamma,
        eta_mean=accum.sum_eta / n_s,
        eta_star=accum.star_eta,
        mean_loglik=accum.sum_loglik / n_s,
        star_loglik=accum.star_loglik,
        loglik_trace=trace,
        accept_gamma=accum.acc_gamma / cfg.total_sweeps,
        accept_eta=accum.acc_eta / cfg.total_sweeps,
        accept_gamma_post=accum.acc_gamma_post / n_s,
        accept_eta_post=accum.acc_eta_post / n_s,
        **extra,
    )


@partial(jax.jit, static_argnames=("cfg", "tau_sweep"))
def run_chain(
    n: jax.Array,
    cfg: SamplerConfig,
    key: jax.Array,
    eta_init: Optional[jax.Array] = None,
    tau_init: Optional[jax.Array] = None,
    gamma_init: Optional[jax.Array] = None,
    tau_sweep=tau_sweep_xla,
) -> SamplerResult:
    """Run one chain end-to-end (init -> scan over sweeps -> summaries).

    n: [V,S,4] float32 counts. Deterministic in (n, cfg, key) by construction
    (counter-based PRNG) — the same inputs give the same trajectory on any
    mesh shape (SURVEY.md §7.1).
    """
    n = n.astype(jnp.float32)
    V, S, _ = n.shape
    state = init_state(n, cfg, key, eta_init, tau_init, gamma_init)
    accum = init_accum(V, S, cfg.G)
    sweep = make_sweep_fn(cfg, tau_sweep)

    def step(carry, it):
        state, accum = carry
        state, accum, ll = sweep(n, state, accum, it)
        return (state, accum), ll

    if cfg.store_samples:
        # burn phase without draw storage, then sampling phase in chunks of
        # store_thin sweeps keeping the last state of each chunk — identical
        # trajectory (randomness folds the same absolute sweep indices),
        # memory = samples/thin snapshots instead of burn+samples.
        thin = max(int(cfg.store_thin), 1)
        if cfg.samples % thin != 0:
            raise ValueError(
                f"store_thin={thin} must divide samples={cfg.samples}"
            )
        (state, accum), trace_burn = jax.lax.scan(
            step, (state, accum), jnp.arange(cfg.burn)
        )

        def chunk(carry, its):
            carry, lls = jax.lax.scan(step, carry, its)
            st = carry[0]
            return carry, (lls, st.tau.astype(jnp.int8), st.gamma, st.eta)

        its = cfg.burn + jnp.arange(cfg.samples).reshape(-1, thin)
        (state, accum), (lls, tau_s, gamma_s, eta_s) = jax.lax.scan(
            chunk, (state, accum), its
        )
        trace = jnp.concatenate([trace_burn, lls.reshape(-1)])
    else:
        (state, accum), trace = jax.lax.scan(
            step, (state, accum), jnp.arange(cfg.total_sweeps)
        )
        tau_s = gamma_s = eta_s = None

    return _result_from_accum(
        accum, cfg, trace,
        tau_samples=tau_s, gamma_samples=gamma_s, eta_samples=eta_s,
    )


def pt_ladder(R: int, max_temp: float):
    """Geometric temperature ladder, rung 0 cold (T=1)."""
    return jnp.float32(max_temp) ** (jnp.arange(R, dtype=jnp.float32) / (R - 1))


def pt_init(n, cfg: SamplerConfig, key, R: int, eta_init=None, tau_init=None,
            gamma_init=None, replica_sharding=None):
    """(states[R], accums[R], rung[R]) for a replica-exchange run."""
    V, S, _ = n.shape
    k_init, _ = jax.random.split(key)
    keys = jax.random.split(k_init, R)
    if replica_sharding is not None:
        # shard the replica axis over the mesh's chain axis (the exchange
        # needs only the R logliks, so replicas never communicate state)
        keys = jax.lax.with_sharding_constraint(keys, replica_sharding)
    states = jax.vmap(
        lambda k: init_state(n, cfg, k, eta_init, tau_init, gamma_init)
    )(keys)
    accum0 = init_accum(V, S, cfg.G)
    accums = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (R,) + jnp.shape(x)), accum0
    )
    return states, accums, jnp.arange(R)


def make_pt_step(n, cfg: SamplerConfig, key, R: int, max_temp: float,
                 tau_sweep=tau_sweep_xla, burn=None):
    """One PT sweep+exchange as a scan step over absolute sweep index.

    carry = (states[R], accums[R], rung[R]); ys = (cold_ll, n_acc, n_heads).
    Randomness folds the absolute sweep index into per-replica keys and the
    run key, so segmented execution (checkpoint.run_chain_pt_checkpointed)
    reproduces an uninterrupted run bitwise. ``burn`` (traced) overrides
    cfg.burn for the accumulation/adaptation gates, exactly like
    make_sweep_fn's — converge.run_chain_pt_auto decides burn at runtime.
    """
    ladder = pt_ladder(R, max_temp)
    _, k_swap = jax.random.split(key)
    sweep = make_sweep_fn(cfg, tau_sweep)
    idx = jnp.arange(R)

    def step(carry, it):
        # rung[i]: which ladder rung replica i currently holds
        states, accums, rung = carry
        temps = ladder[rung]
        betas = 1.0 / temps
        new_states, new_accums, lls = jax.vmap(
            lambda st, ac, t, b: sweep(n, st, ac, it, temp=t, beta=b,
                                       burn=burn)
        )(states, accums, temps, betas)
        is_cold = (rung == 0)
        # keep the pre-sweep accum for hot replicas (their draws are from
        # tempered targets and must not enter the posterior averages)
        accums = jax.tree_util.tree_map(
            lambda new, old: jnp.where(
                is_cold.reshape((R,) + (1,) * (new.ndim - 1)), new, old
            ),
            new_accums, accums,
        )
        states = new_states

        # adjacent-RUNG exchange, alternating parity by sweep: propose
        # swapping the temperatures of the replicas holding rungs (r, r+1)
        ll = states.loglik                                   # [R] by replica
        order = jnp.argsort(rung)                            # rung -> replica
        ll_by_rung = ll[order]
        beta_ladder = 1.0 / ladder
        delta = (beta_ladder - jnp.roll(beta_ladder, -1)) * (
            jnp.roll(ll_by_rung, -1) - ll_by_rung
        )
        is_head = ((idx % 2) == (it % 2)) & (idx + 1 < R)
        u = jax.random.uniform(jax.random.fold_in(k_swap, it), (R,))
        acc = is_head & (safe_log(u) < delta)
        acc_prev = jnp.concatenate([jnp.zeros((1,), bool), acc[:-1]])
        # sigma: old rung -> new rung (disjoint adjacent transpositions,
        # its own inverse); each replica's rung moves through sigma
        rung_perm = jnp.where(acc, idx + 1, jnp.where(acc_prev, idx - 1, idx))
        new_rung = rung_perm[rung]
        # adapted proposal scales belong to the TEMPERATURE, not the replica
        # (state-swap PT keeps them with the rung): re-gather them so the
        # kappa tuned at rung r stays at rung r. order[x] = old holder of
        # rung x, so the new holder of rung new_rung[i] takes its kappa.
        kappa_src = order[new_rung]
        states = states._replace(
            kappa_gamma=states.kappa_gamma[kappa_src],
            kappa_eta=states.kappa_eta[kappa_src],
        )
        rung = new_rung
        n_acc = jnp.sum(acc.astype(jnp.float32))
        n_heads = jnp.sum(is_head.astype(jnp.float32))
        cold_ll = jnp.sum(jnp.where(is_cold, lls, 0.0))
        return (states, accums, rung), (cold_ll, n_acc, n_heads)

    return step


def pt_merge_accums(accums: SamplerAccum) -> SamplerAccum:
    """Merge per-replica cold-rung records: sums add, stars max-merge."""
    def _sum(x):
        return jnp.sum(x, axis=0)

    star_rep = jnp.argmax(accums.star_loglik)
    return SamplerAccum(
        sum_tau=_sum(accums.sum_tau),
        sum_gamma=_sum(accums.sum_gamma),
        sum_eta=_sum(accums.sum_eta),
        sum_loglik=_sum(accums.sum_loglik),
        n_samples=_sum(accums.n_samples),
        star_loglik=accums.star_loglik[star_rep],
        star_tau=accums.star_tau[star_rep],
        star_gamma=accums.star_gamma[star_rep],
        star_eta=accums.star_eta[star_rep],
        # exactly one replica is cold each sweep, so the cross-replica sums
        # already total cfg.total_sweeps cold-sweep acceptance values
        acc_gamma=_sum(accums.acc_gamma),
        acc_eta=_sum(accums.acc_eta),
        acc_gamma_post=_sum(accums.acc_gamma_post),
        acc_eta_post=_sum(accums.acc_eta_post),
    )


@partial(jax.jit, static_argnames=("cfg", "n_replicas", "tau_sweep",
                                   "replica_sharding"))
def run_chain_pt(
    n: jax.Array,
    cfg: SamplerConfig,
    key: jax.Array,
    n_replicas: int = 4,
    max_temp: float = 8.0,
    eta_init: Optional[jax.Array] = None,
    tau_init: Optional[jax.Array] = None,
    gamma_init: Optional[jax.Array] = None,
    tau_sweep=tau_sweep_xla,
    replica_sharding=None,
) -> SamplerResult:
    """Parallel tempering (replica exchange) — a convergence upgrade the
    reference has no analogue for (its mitigation is independent restarts,
    SURVEY.md §2.2 'multi-chain parallel').

    R replicas run on a temperature ladder T_r = max_temp^(r/(R-1)) (rung 0
    cold, T=1), each targeting pi_r = prior * L^(1/T_r): the tau Gibbs
    conditional is raised to 1/T_r via the Gumbel-temperature trick and every
    MH acceptance scales its likelihood term by 1/T_r. After every sweep,
    adjacent rungs (alternating parity) propose an exchange accepted with
    prob min(1, exp((b_r - b_{r+1}) (ll_{r+1} - ll_r))) — the priors are
    untempered on every rung so they cancel. The exchange swaps the
    TEMPERATURES between the two replicas (equivalent to the textbook
    state swap, but it moves R scalars instead of gathering the [V,S,4]
    states through HBM every sweep — and it keeps each replica's state
    shard-local under a mesh). Samples/star are recorded only while a
    replica holds the cold rung; hot rungs exist to carry the chain across
    posterior modes (label-permutation and strain-splitting modes) that
    single-temperature Gibbs crosses exponentially slowly.

    Replicas are vmapped — on a (chain, data) mesh they shard like chains.
    Cost: R x one chain; exchange overhead is R scalars per sweep.
    """
    n = n.astype(jnp.float32)
    R = int(n_replicas)
    if R < 2:
        return run_chain(n, cfg, key, eta_init=eta_init, tau_init=tau_init,
                         gamma_init=gamma_init, tau_sweep=tau_sweep)
    states, accums, rung = pt_init(
        n, cfg, key, R, eta_init=eta_init, tau_init=tau_init,
        gamma_init=gamma_init, replica_sharding=replica_sharding,
    )
    step = make_pt_step(n, cfg, key, R, max_temp, tau_sweep)
    if cfg.store_samples:
        # store the COLD chain's post-burn draws (thinned), mirroring
        # run_chain's chunked storage: the replica holding rung 0 after the
        # sweep's exchange is the cold-target sample (VERDICT r1 item 6 —
        # --store_every now composes with --pt)
        thin = max(int(cfg.store_thin), 1)
        if cfg.samples % thin != 0:
            raise ValueError(
                f"store_thin={thin} must divide samples={cfg.samples}"
            )
        carry = (states, accums, rung)
        carry, ys_burn = jax.lax.scan(step, carry, jnp.arange(cfg.burn))

        def chunk(carry, its):
            carry, ys = jax.lax.scan(step, carry, its)
            st, _, rg = carry
            cold = jnp.argmin(rg)  # replica currently holding rung 0
            return carry, (ys, st.tau[cold].astype(jnp.int8),
                           st.gamma[cold], st.eta[cold])

        its = cfg.burn + jnp.arange(cfg.samples).reshape(-1, thin)
        carry, (ys, tau_s, gamma_s, eta_s) = jax.lax.scan(chunk, carry, its)
        (states, accums, rung) = carry
        trace = jnp.concatenate([ys_burn[0], ys[0].reshape(-1)])
        n_accs = jnp.concatenate([ys_burn[1], ys[1].reshape(-1)])
        n_heads = jnp.concatenate([ys_burn[2], ys[2].reshape(-1)])
    else:
        (states, accums, rung), (trace, n_accs, n_heads) = jax.lax.scan(
            step, (states, accums, rung), jnp.arange(cfg.total_sweeps)
        )
        tau_s = gamma_s = eta_s = None
    accum = pt_merge_accums(accums)
    # per-proposal rate: sweeps whose parity yields no eligible pair (R=2,
    # odd sweeps) contribute no proposals, not zero-acceptance ones
    swap_rate = jnp.sum(n_accs) / jnp.maximum(jnp.sum(n_heads), 1.0)
    return _result_from_accum(
        accum, cfg, trace, pt_swap_accept=swap_rate,
        tau_samples=tau_s, gamma_samples=gamma_s, eta_samples=eta_s,
    )


def run_chains(
    n: jax.Array,
    cfg: SamplerConfig,
    seeds,
    eta_init: Optional[jax.Array] = None,
    tau_init: Optional[jax.Array] = None,
    tau_sweep=tau_sweep_xla,
) -> SamplerResult:
    """vmap independent chains over seeds (the reference's shell-level
    replicate fan-out, SURVEY.md §2.2, collapsed into one device program)."""
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in np.asarray(seeds)])
    fn = lambda k: run_chain(n, cfg, k, eta_init=eta_init, tau_init=tau_init,
                             tau_sweep=tau_sweep)
    return jax.vmap(fn)(keys)


def run_chains_pt(
    n: jax.Array,
    cfg: SamplerConfig,
    seeds,
    n_replicas: int = 4,
    max_temp: float = 8.0,
    eta_init: Optional[jax.Array] = None,
    tau_init: Optional[jax.Array] = None,
    tau_sweep=tau_sweep_xla,
) -> SamplerResult:
    """vmap independent parallel-tempering runs over seeds (chains x replicas
    nested batching — the full replicate fan-out of SURVEY.md §2.2 with the
    mixing upgrade of run_chain_pt in one device program)."""
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in np.asarray(seeds)])
    fn = lambda k: run_chain_pt(
        n, cfg, k, n_replicas=n_replicas, max_temp=max_temp,
        eta_init=eta_init, tau_init=tau_init, tau_sweep=tau_sweep,
    )
    return jax.vmap(fn)(keys)


def total_coeff(n: np.ndarray) -> float:
    """Constant multinomial-coefficient term of logL (host-side, once)."""
    return float(
        jax.device_get(jnp.sum(log_multinomial_coeff(jnp.asarray(n, jnp.float32))))
    )


def deviance_from_loglik(loglik: float, coeff: float) -> float:
    return -2.0 * (loglik + coeff)
