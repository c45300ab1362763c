"""Checkpoint / exact resume for sampler chains.

The reference has no within-run checkpointing — a crashed run is re-run
(SURVEY.md §5). Here a run can be executed as segments of sweeps with the
full chain state (tau, gamma, eta, mixture cache, PRNG key, sweep index,
posterior accumulators) serialized to a single .npz between segments.
Because every sweep derives its randomness by folding the *absolute* sweep
index into the chain key (sampler.make_sweep_fn), a resumed run continues
the exact trajectory of an uninterrupted one (tested bitwise in
tests/test_checkpoint.py).
"""
from __future__ import annotations

import os
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .sampler import (
    SamplerAccum, SamplerConfig, SamplerResult, SamplerState, init_accum,
    init_state, make_pt_step, make_sweep_fn, pt_init, pt_merge_accums,
    tau_sweep_xla,
)
from .sampler import _result_from_accum  # shared result assembly

_STATE_FIELDS = SamplerState._fields
_ACCUM_FIELDS = SamplerAccum._fields


class Preempted(Exception):
    """Raised between segments after a SIGTERM: the checkpoint on disk is
    committed and the run is resumable (the CLI exits 75, EX_TEMPFAIL)."""


_PREEMPTED = False


def _on_sigterm(signum, frame):  # pragma: no cover - exercised via CLI test
    global _PREEMPTED
    _PREEMPTED = True


def install_preemption_handler() -> None:
    """SIGTERM = preemption notice (the batch-scheduler eviction contract): finish
    the in-flight segment, commit its checkpoint, then raise Preempted at
    the next segment boundary instead of dying mid-save. Installed by the
    CLI for checkpointed runs; safe to call more than once."""
    import signal as _signal

    _signal.signal(_signal.SIGTERM, _on_sigterm)


def check_preempted() -> None:
    global _PREEMPTED
    if _PREEMPTED:
        _PREEMPTED = False
        raise Preempted("SIGTERM received; checkpoint committed — rerun to "
                        "resume")


def save(path: str, state: SamplerState, accum: SamplerAccum, it: int,
         trace: np.ndarray, extras: Optional[dict] = None) -> None:
    """Serialize a chain snapshot atomically (write + rename).

    ``extras``: caller-owned arrays saved alongside the chain state (e.g.
    converge.run_chains_auto's plateau-detector state); read back with
    ``load_extras``.
    """
    payload = {f"state_{k}": np.asarray(v) for k, v in zip(_STATE_FIELDS, state)}
    payload.update(
        {f"accum_{k}": np.asarray(v) for k, v in zip(_ACCUM_FIELDS, accum)}
    )
    payload["it"] = np.asarray(it, np.int64)
    payload["trace"] = np.asarray(trace, np.float32)
    for k, v in (extras or {}).items():
        payload[f"extra_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    # np.savez appends .npz only when missing; tmp already ends with it
    os.replace(tmp, path)


def load(path: str) -> Tuple[SamplerState, SamplerAccum, int, np.ndarray]:
    z = np.load(path)
    state = SamplerState(*[jnp.asarray(z[f"state_{k}"]) for k in _STATE_FIELDS])
    accum = SamplerAccum(*[jnp.asarray(z[f"accum_{k}"]) for k in _ACCUM_FIELDS])
    return state, accum, int(z["it"]), np.asarray(z["trace"])


def load_extras(path: str) -> dict:
    """The ``extras`` dict a snapshot was saved with (empty if none)."""
    z = np.load(path)
    return {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}


@partial(jax.jit, static_argnames=("cfg", "n_sweeps", "tau_sweep"))
def run_segment(
    n: jax.Array,
    cfg: SamplerConfig,
    state: SamplerState,
    accum: SamplerAccum,
    start_it: int,
    n_sweeps: int,
    tau_sweep=tau_sweep_xla,
    burn=None,
):
    """Advance a chain n_sweeps from absolute sweep index start_it.

    ``burn`` (traced scalar) overrides cfg.burn for the accumulation/
    adaptation gates — converge.run_chain_auto varies it at runtime
    without triggering a recompile per plateau point."""
    sweep = make_sweep_fn(cfg, tau_sweep)

    def step(carry, it):
        state, accum = carry
        state, accum, ll = sweep(n, state, accum, it, burn=burn)
        return (state, accum), ll

    (state, accum), trace = jax.lax.scan(
        step, (state, accum), start_it + jnp.arange(n_sweeps)
    )
    return state, accum, trace


@partial(jax.jit, static_argnames=("cfg", "n_sweeps", "tau_sweep"))
def run_segment_store(
    n: jax.Array,
    cfg: SamplerConfig,
    state: SamplerState,
    accum: SamplerAccum,
    start_it: int,
    n_sweeps: int,
    tau_sweep=tau_sweep_xla,
    burn=None,
):
    """run_segment that also emits every sweep's (tau int8, gamma, eta).

    The per-sweep draw stream lets segmented runs reproduce run_chain's
    thinned posterior-draw storage exactly: the host keeps only the sweeps
    ``stored_slots`` selects (the same absolute-sweep grid run_chain's
    chunked scan snapshots), so a checkpointed --store_every run returns
    bitwise the draws of an uninterrupted one."""
    sweep = make_sweep_fn(cfg, tau_sweep)

    def step(carry, it):
        state, accum = carry
        state, accum, ll = sweep(n, state, accum, it, burn=burn)
        return (state, accum), (ll, state.tau.astype(jnp.int8),
                                state.gamma, state.eta)

    (state, accum), (trace, tau_s, gamma_s, eta_s) = jax.lax.scan(
        step, (state, accum), start_it + jnp.arange(n_sweeps)
    )
    return state, accum, trace, tau_s, gamma_s, eta_s


def stored_slots(start_it: int, n_sweeps: int, burn: int, thin: int):
    """Local indices of draws a segment [start_it, start_it+n_sweeps) keeps.

    run_chain's store path snapshots the state after each chunk of ``thin``
    post-burn sweeps, i.e. at absolute sweep a with a >= burn and
    (a - burn + 1) % thin == 0 — this reproduces that grid segment-locally.
    """
    thin = max(int(thin), 1)
    return [
        j for j in range(n_sweeps)
        if start_it + j >= burn and (start_it + j - burn + 1) % thin == 0
    ]


class _DrawBuf:
    """Host-side accumulator for thinned (tau, gamma, eta) draws across
    segments, persisted through the checkpoint ``extras`` channel."""

    KEYS = ("draw_tau", "draw_gamma", "draw_eta")

    def __init__(self, extras: Optional[dict] = None):
        ex = extras or {}
        self.tau = [np.asarray(ex["draw_tau"])] if "draw_tau" in ex else []
        self.gamma = [np.asarray(ex["draw_gamma"])] if "draw_gamma" in ex else []
        self.eta = [np.asarray(ex["draw_eta"])] if "draw_eta" in ex else []

    def append(self, slots, tau_s, gamma_s, eta_s, axis: int = 0):
        """Keep the ``slots`` entries of a segment's per-sweep draw stream.

        ``axis``: the sweep axis (0 for single-chain streams, 1 under a
        leading chain axis)."""
        if not slots:
            return
        idx = np.asarray(slots)
        self.tau.append(np.take(np.asarray(tau_s), idx, axis=axis))
        self.gamma.append(np.take(np.asarray(gamma_s), idx, axis=axis))
        self.eta.append(np.take(np.asarray(eta_s), idx, axis=axis))

    def truncate(self, n_draws: int, axis: int = 0) -> None:
        """Drop draws beyond the first n_draws along the sweep axis (resume
        hygiene when the draw file committed ahead of the state snapshot)."""
        ex = self.extras(axis=axis)
        if not ex:
            return
        sl = (slice(None),) * axis + (slice(0, n_draws),)
        self.tau = [ex["draw_tau"][sl]]
        self.gamma = [ex["draw_gamma"][sl]]
        self.eta = [ex["draw_eta"][sl]]

    def extras(self, axis: int = 0) -> dict:
        if not self.tau:
            return {}
        return {"draw_tau": np.concatenate(self.tau, axis=axis),
                "draw_gamma": np.concatenate(self.gamma, axis=axis),
                "draw_eta": np.concatenate(self.eta, axis=axis)}

    def result_fields(self, axis: int = 0) -> dict:
        ex = self.extras(axis=axis)
        if not ex:
            return {}
        return {"tau_samples": jnp.asarray(ex["draw_tau"]),
                "gamma_samples": jnp.asarray(ex["draw_gamma"]),
                "eta_samples": jnp.asarray(ex["draw_eta"])}


def run_chain_checkpointed(
    n: jax.Array,
    cfg: SamplerConfig,
    key: jax.Array,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    eta_init=None,
    tau_init=None,
    tau_sweep=tau_sweep_xla,
) -> SamplerResult:
    """run_chain with periodic checkpoints and automatic resume.

    If checkpoint_path exists the run resumes from it; otherwise it starts
    fresh. The final result is identical to sampler.run_chain with the same
    (n, cfg, key) regardless of how many times the run was interrupted —
    including the thinned posterior draws when cfg.store_samples is on
    (draws accumulated so far ride the checkpoint's extras channel).
    """
    n = n.astype(jnp.float32)
    V, S, _ = n.shape

    if os.path.exists(checkpoint_path):
        state, accum, it, trace_done = load(checkpoint_path)
        trace_parts = [trace_done[:it]]
        draws = _DrawBuf(load_extras(checkpoint_path))
    else:
        state = init_state(n, cfg, key, eta_init, tau_init)
        accum = init_accum(V, S, cfg.G)
        it = 0
        trace_parts = []
        draws = _DrawBuf()

    while it < cfg.total_sweeps:
        check_preempted()
        seg = min(checkpoint_every, cfg.total_sweeps - it)
        if cfg.store_samples:
            state, accum, trace, tau_s, gamma_s, eta_s = run_segment_store(
                n, cfg, state, accum, it, seg, tau_sweep=tau_sweep
            )
            draws.append(stored_slots(it, seg, cfg.burn, cfg.store_thin),
                         tau_s, gamma_s, eta_s)
        else:
            state, accum, trace = run_segment(
                n, cfg, state, accum, it, seg, tau_sweep=tau_sweep
            )
        it += seg
        trace_parts.append(np.asarray(trace))
        save(checkpoint_path, state, accum, it, np.concatenate(trace_parts),
             extras=draws.extras())

    trace = jnp.asarray(np.concatenate(trace_parts))
    return _result_from_accum(accum, cfg, trace, **draws.result_fields())


@partial(jax.jit, static_argnames=("cfg", "n_sweeps", "tau_sweep"))
def run_segment_chains(
    n: jax.Array,
    cfg: SamplerConfig,
    states: SamplerState,
    accums: SamplerAccum,
    start_it: int,
    n_sweeps: int,
    tau_sweep=tau_sweep_xla,
    burn=None,
):
    """run_segment vmapped over a leading chain axis of states/accums.

    ``burn`` (traced scalar, shared by all chains) has run_segment's
    semantics. Under a (chain, data) mesh the chain axis shards over
    'chain' and positions over 'data' exactly as run_chains_sharded —
    shardings propagate from the inputs."""
    f = lambda st, ac: run_segment(
        n, cfg, st, ac, start_it, n_sweeps, tau_sweep=tau_sweep, burn=burn
    )
    return jax.vmap(f)(states, accums)


@partial(jax.jit, static_argnames=("cfg", "n_sweeps", "tau_sweep"))
def run_segment_chains_store(
    n: jax.Array,
    cfg: SamplerConfig,
    states: SamplerState,
    accums: SamplerAccum,
    start_it: int,
    n_sweeps: int,
    tau_sweep=tau_sweep_xla,
    burn=None,
):
    """run_segment_store vmapped over a leading chain axis: the draw stream
    comes back as [C, n_sweeps, ...]."""
    f = lambda st, ac: run_segment_store(
        n, cfg, st, ac, start_it, n_sweeps, tau_sweep=tau_sweep, burn=burn
    )
    return jax.vmap(f)(states, accums)


def init_chains(n, cfg: SamplerConfig, keys, eta_init=None, tau_init=None,
                out_shardings=None):
    """Vmapped (states, accums) for a fresh multi-chain run ([C]-leading)."""
    C = keys.shape[0]
    V, S, _ = n.shape
    init = jax.vmap(lambda k: init_state(n, cfg, k, eta_init, tau_init))
    if out_shardings is not None:
        init = jax.jit(init, out_shardings=out_shardings)
    states = init(keys)
    accums = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (C,) + jnp.shape(x)),
        init_accum(V, S, cfg.G),
    )
    return states, accums


def run_chains_checkpointed(
    n: jax.Array,
    cfg: SamplerConfig,
    keys: jax.Array,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    eta_init=None,
    tau_init=None,
    tau_sweep=tau_sweep_xla,
) -> SamplerResult:
    """sampler.run_chains with periodic checkpoints and automatic resume.

    keys: [C,2] stacked PRNG keys. One npz holds every chain's state with a
    leading chain axis; the final result is identical to run_chains with the
    same seeds regardless of interruptions (VERDICT r1 item 4: the
    --checkpoint x --chains cell of the CLI capability matrix). With
    cfg.store_samples the per-chain thinned draws ([C, k, ...]) survive
    interruption too, via the extras channel.
    """
    n = n.astype(jnp.float32)

    if os.path.exists(checkpoint_path):
        states, accums, it, trace_done = load(checkpoint_path)
        trace_parts = [trace_done[:, :it]]
        draws = _DrawBuf(load_extras(checkpoint_path))
    else:
        states, accums = init_chains(n, cfg, keys, eta_init, tau_init)
        it = 0
        trace_parts = []
        draws = _DrawBuf()

    while it < cfg.total_sweeps:
        check_preempted()
        seg = min(checkpoint_every, cfg.total_sweeps - it)
        if cfg.store_samples:
            states, accums, trace, tau_s, gamma_s, eta_s = (
                run_segment_chains_store(
                    n, cfg, states, accums, it, seg, tau_sweep=tau_sweep
                ))
            draws.append(stored_slots(it, seg, cfg.burn, cfg.store_thin),
                         tau_s, gamma_s, eta_s, axis=1)
        else:
            states, accums, trace = run_segment_chains(
                n, cfg, states, accums, it, seg, tau_sweep=tau_sweep
            )
        it += seg
        trace_parts.append(np.asarray(trace))
        save(checkpoint_path, states, accums, it,
             np.concatenate(trace_parts, axis=1), extras=draws.extras(axis=1))

    trace = jnp.asarray(np.concatenate(trace_parts, axis=1))
    fields = draws.result_fields(axis=1)
    return jax.vmap(lambda ac, tr: _result_from_accum(ac, cfg, tr))(
        accums, trace
    )._replace(**fields)


# --------------------------------------------------------------------------
# parallel-tempering checkpointing (replica states + rung assignment)
# --------------------------------------------------------------------------

def save_pt(path: str, states: SamplerState, accums: SamplerAccum,
            rung, it: int, trace: np.ndarray, n_acc: float,
            n_heads: float) -> None:
    """Serialize a PT snapshot ([R]-leading replica pytrees) atomically."""
    payload = {f"state_{k}": np.asarray(v) for k, v in zip(_STATE_FIELDS, states)}
    payload.update(
        {f"accum_{k}": np.asarray(v) for k, v in zip(_ACCUM_FIELDS, accums)}
    )
    payload["rung"] = np.asarray(rung)
    payload["it"] = np.asarray(it, np.int64)
    payload["trace"] = np.asarray(trace, np.float32)
    payload["n_acc"] = np.asarray(n_acc, np.float64)
    payload["n_heads"] = np.asarray(n_heads, np.float64)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_pt(path: str):
    z = np.load(path)
    states = SamplerState(*[jnp.asarray(z[f"state_{k}"]) for k in _STATE_FIELDS])
    accums = SamplerAccum(*[jnp.asarray(z[f"accum_{k}"]) for k in _ACCUM_FIELDS])
    return (states, accums, jnp.asarray(z["rung"]), int(z["it"]),
            np.asarray(z["trace"]), float(z["n_acc"]), float(z["n_heads"]))


@partial(jax.jit, static_argnames=("cfg", "n_sweeps", "max_temp", "tau_sweep"))
def run_pt_segment(
    n: jax.Array,
    cfg: SamplerConfig,
    key: jax.Array,
    states: SamplerState,
    accums: SamplerAccum,
    rung: jax.Array,
    start_it: int,
    n_sweeps: int,
    max_temp: float,
    tau_sweep=tau_sweep_xla,
    burn=None,
):
    """Advance a PT ensemble n_sweeps from absolute sweep index start_it.

    key must be the ORIGINAL run key (the exchange stream folds absolute
    sweep indices into it, so segments reproduce an uninterrupted run).
    ``burn`` (traced) overrides cfg.burn for the accumulation gates
    (converge.run_chain_pt_auto)."""
    R = rung.shape[0]
    step = make_pt_step(n, cfg, key, R, max_temp, tau_sweep, burn=burn)
    (states, accums, rung), (trace, n_accs, n_heads) = jax.lax.scan(
        step, (states, accums, rung), start_it + jnp.arange(n_sweeps)
    )
    return states, accums, rung, trace, jnp.sum(n_accs), jnp.sum(n_heads)


@partial(jax.jit, static_argnames=("cfg", "n_sweeps", "max_temp", "tau_sweep"))
def run_pt_segment_store(
    n: jax.Array,
    cfg: SamplerConfig,
    key: jax.Array,
    states: SamplerState,
    accums: SamplerAccum,
    rung: jax.Array,
    start_it: int,
    n_sweeps: int,
    max_temp: float,
    tau_sweep=tau_sweep_xla,
    burn=None,
):
    """run_pt_segment that also emits each sweep's COLD-rung (tau int8,
    gamma, eta) — the replica holding rung 0 after the sweep's exchange,
    matching run_chain_pt's stored-draw semantics."""
    R = rung.shape[0]
    step = make_pt_step(n, cfg, key, R, max_temp, tau_sweep, burn=burn)

    def step_store(carry, it):
        carry, ys = step(carry, it)
        st, _, rg = carry
        cold = jnp.argmin(rg)
        return carry, (ys, st.tau[cold].astype(jnp.int8),
                       st.gamma[cold], st.eta[cold])

    (states, accums, rung), (ys, tau_s, gamma_s, eta_s) = jax.lax.scan(
        step_store, (states, accums, rung), start_it + jnp.arange(n_sweeps)
    )
    trace, n_accs, n_heads = ys
    return (states, accums, rung, trace, jnp.sum(n_accs), jnp.sum(n_heads),
            tau_s, gamma_s, eta_s)


def run_chain_pt_checkpointed(
    n: jax.Array,
    cfg: SamplerConfig,
    key: jax.Array,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    n_replicas: int = 4,
    max_temp: float = 8.0,
    eta_init=None,
    tau_init=None,
    tau_sweep=tau_sweep_xla,
) -> SamplerResult:
    """run_chain_pt with periodic checkpoints and automatic resume; the
    final result is identical to an uninterrupted run_chain_pt with the
    same (n, cfg, key, n_replicas, max_temp) — including the cold-rung
    thinned draws when cfg.store_samples is on (they ride the PT snapshot
    like the plain path's extras channel)."""
    n = n.astype(jnp.float32)
    R = int(n_replicas)
    if R < 2:  # same degenerate-ladder fallback as run_chain_pt
        return run_chain_checkpointed(
            n, cfg, key, checkpoint_path, checkpoint_every=checkpoint_every,
            eta_init=eta_init, tau_init=tau_init, tau_sweep=tau_sweep,
        )

    draws_path = checkpoint_path + ".draws.npz"
    if os.path.exists(checkpoint_path):
        states, accums, rung, it, trace_done, acc_sum, head_sum = load_pt(
            checkpoint_path)
        trace_parts = [trace_done[:it]]
        draws = _DrawBuf(load_extras(draws_path)
                         if os.path.exists(draws_path) else None)
        # the draws file commits before the snapshot; a crash between the two
        # leaves it one segment ahead — truncate to the committed sweep count
        n_committed = len(stored_slots(0, it, cfg.burn, cfg.store_thin))
        draws.truncate(n_committed)
    else:
        states, accums, rung = pt_init(n, cfg, key, R, eta_init=eta_init,
                                       tau_init=tau_init)
        it, acc_sum, head_sum = 0, 0.0, 0.0
        trace_parts = []
        draws = _DrawBuf()

    while it < cfg.total_sweeps:
        check_preempted()
        seg = min(checkpoint_every, cfg.total_sweeps - it)
        if cfg.store_samples:
            (states, accums, rung, trace, n_acc, n_heads,
             tau_s, gamma_s, eta_s) = run_pt_segment_store(
                n, cfg, key, states, accums, rung, it, seg, max_temp,
                tau_sweep=tau_sweep,
            )
            draws.append(stored_slots(it, seg, cfg.burn, cfg.store_thin),
                         tau_s, gamma_s, eta_s)
        else:
            states, accums, rung, trace, n_acc, n_heads = run_pt_segment(
                n, cfg, key, states, accums, rung, it, seg, max_temp,
                tau_sweep=tau_sweep,
            )
        it += seg
        acc_sum += float(n_acc)
        head_sum += float(n_heads)
        trace_parts.append(np.asarray(trace))
        if cfg.store_samples:  # draws first: manifest-last ordering is the
            ex = draws.extras()  # pt snapshot itself (save_pt renames last)
            np.savez(draws_path + ".tmp.npz",
                     **{f"extra_{k}": v for k, v in ex.items()})
            os.replace(draws_path + ".tmp.npz", draws_path)
        save_pt(checkpoint_path, states, accums, rung, it,
                np.concatenate(trace_parts), acc_sum, head_sum)

    trace = jnp.asarray(np.concatenate(trace_parts))
    accum = pt_merge_accums(accums)
    swap_rate = jnp.float32(acc_sum / max(head_sum, 1.0))
    return _result_from_accum(accum, cfg, trace, pt_swap_accept=swap_rate,
                              **draws.result_fields())
