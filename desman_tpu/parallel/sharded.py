"""Mesh-sharded sampler execution.

Runs the same ``run_chain`` program as the single-device path, but with inputs
placed on a (chain, data) mesh: GSPMD propagates the shardings through the
scan — tau/mix stay position-sharded, gamma/eta/logliks become psum-reduced
replicated values. Because `jax.random`'s threefry is partitionable, the
sampled trajectories are bitwise mesh-shape-invariant: the same seeds give
the same chains on 1 device or 64 (tested in tests/test_sharding.py; the
gate demanded by SURVEY.md §7.2 step 6).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import PartitionSpec as P

from ..sampler import SamplerConfig, SamplerResult, run_chain, tau_sweep_xla
from .mesh import (
    DATA_AXIS, Mesh, make_mesh, pad_positions, pad_tau, shard_counts,
    shard_keys,
)


def make_pallas_sweep_sharded(mesh: Mesh, interpret: bool = False,
                              true_V: Optional[int] = None):
    """A tau_sweep for sharded runs that calls the fused Pallas kernel
    per position shard.

    GSPMD cannot partition a pallas_call, so the kernel is wrapped in
    shard_map over the data axis: each device runs the whole-sweep kernel on
    its V-shard (tau conditionals are position-independent given gamma/eta,
    so no communication is needed inside the sweep). The Gumbel noise and
    the swap proposal are drawn globally OUTSIDE the shard_map with the same
    fold_in schemes as every other path, so trajectories remain
    mesh-shape-invariant.

    V must be divisible by the data-axis size (run_chains_sharded pads).
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU
    tests). ``true_V``: the unpadded position count; rows >= true_V (the
    wrapper's global zero-count padding) get +inf swap thresholds so they
    never accept.
    """
    from ..ops.tau_pallas import (
        draw_gumbel, draw_swap_proposal, require_gpu,
        tau_sweep_pallas_from_gz,
    )

    require_gpu(interpret)

    def kernel(n, tau, mix, gamma, eta, gz):
        return tau_sweep_pallas_from_gz(n, tau, mix, gamma, eta, gz,
                                        interpret=interpret)

    def kernel_swap(n, tau, mix, gamma, eta, gz, g_s, h_s, logu, beta):
        return tau_sweep_pallas_from_gz(
            n, tau, mix, gamma, eta, gz, interpret=interpret,
            swap_beta=beta, swap_proposal=(g_s, h_s, logu),
        )

    base_specs = (
        P(DATA_AXIS, None, None),   # n [V,S,4]
        P(DATA_AXIS, None),         # tau [V,G]
        P(DATA_AXIS, None, None),   # mix [V,S,4]
        P(),                        # gamma (replicated)
        P(),                        # eta
        P(DATA_AXIS, None),         # gz [V, G*4]
    )
    swap_specs = base_specs + (
        P(),                        # swap strain g (scalar)
        P(),                        # swap strain h
        P(DATA_AXIS),               # logu [V]
        P(),                        # beta (scalar)
    )
    out_specs = (P(DATA_AXIS, None), P(DATA_AXIS, None, None))

    def wrap(fn, in_specs):
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    sharded_kernel = wrap(kernel, base_specs)
    sharded_kernel_swap = wrap(kernel_swap, swap_specs)

    def sweep(n, tau, mix, gamma, eta, key, temp=1.0, swap_key=None,
              swap_beta=1.0):
        V, G = n.shape[0], tau.shape[1]
        gz = draw_gumbel(key, V, G, temp)
        gamma = gamma.astype(jnp.float32)
        eta = eta.astype(jnp.float32)
        if swap_key is None:
            return sharded_kernel(n, tau, mix, gamma, eta, gz)
        g_s, h_s, logu = draw_swap_proposal(swap_key, V, G)
        if true_V is not None and true_V < V:
            # global pad rows never accept (see factory docstring)
            logu = jnp.where(jnp.arange(V) >= true_V, jnp.inf, logu)
        return sharded_kernel_swap(n, tau, mix, gamma, eta, gz, g_s, h_s,
                                   logu, jnp.float32(swap_beta))

    sweep.handles_swap = True
    return sweep


def run_chains_sharded(
    counts: np.ndarray,
    cfg: SamplerConfig,
    seeds: Sequence[int],
    mesh: Optional[Mesh] = None,
    eta_init=None,
    tau_init=None,
    tau_sweep=tau_sweep_xla,
) -> SamplerResult:
    """Position-sharded, chain-parallel sampler run.

    counts: host [V,S,4]; V is zero-padded to the data-axis size (neutral —
    see ``pad_positions``). Results are returned with the padding stripped.
    """
    mesh = mesh or make_mesh()
    n_data = mesh.shape["data"]
    padded, V = pad_positions(np.asarray(counts, np.float32), n_data)

    n_dev = shard_counts(jnp.asarray(padded), mesh)
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    keys_dev = shard_keys(keys, mesh)
    eta = None if eta_init is None else jnp.asarray(eta_init, jnp.float32)
    tau0 = (None if tau_init is None
            else jnp.asarray(pad_tau(tau_init, n_data), jnp.int32))

    @jax.jit
    def go(n, keys):
        return jax.vmap(
            lambda k: run_chain(n, cfg, k, eta_init=eta, tau_init=tau0,
                                tau_sweep=tau_sweep)
        )(keys)

    res = go(n_dev, keys_dev)
    # only the position-axis fields carry padding (incl. stored draws:
    # tau_samples is [chain, draws, V_padded, G] when store_samples is on)
    res = res._replace(tau_mean=res.tau_mean[:, :V], tau_star=res.tau_star[:, :V])
    if res.tau_samples is not None:
        res = res._replace(tau_samples=res.tau_samples[:, :, :V])
    return res


def _state_shardings(mesh: Mesh):
    """NamedSharding per SamplerState field (position axis over 'data')."""
    from jax.sharding import NamedSharding

    from ..sampler import SamplerState

    def sh(spec):
        return NamedSharding(mesh, spec)

    return SamplerState(
        tau=sh(P(DATA_AXIS, None)), gamma=sh(P()), eta=sh(P()),
        mix=sh(P(DATA_AXIS, None, None)), loglik=sh(P()), key=sh(P()),
        kappa_gamma=sh(P()), kappa_eta=sh(P()),
    )


def _accum_shardings(mesh: Mesh):
    from jax.sharding import NamedSharding

    from ..sampler import SamplerAccum

    def sh(spec):
        return NamedSharding(mesh, spec)

    return SamplerAccum(
        sum_tau=sh(P(DATA_AXIS, None, None)), sum_gamma=sh(P()),
        sum_eta=sh(P()), sum_loglik=sh(P()), n_samples=sh(P()),
        star_loglik=sh(P()), star_tau=sh(P(DATA_AXIS, None)),
        star_gamma=sh(P()), star_eta=sh(P()),
        acc_gamma=sh(P()), acc_eta=sh(P()),
        acc_gamma_post=sh(P()), acc_eta_post=sh(P()),
    )


def run_chain_sharded_checkpointed(
    counts: np.ndarray,
    cfg: SamplerConfig,
    key: jax.Array,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    mesh: Optional[Mesh] = None,
    eta_init=None,
    tau_init=None,
    tau_sweep=tau_sweep_xla,
    stop_after: Optional[int] = None,
) -> Optional[SamplerResult]:
    """Position-sharded single chain with periodic checkpoints/exact resume.

    Long big-V runs (the regime sharding exists for — docs/SCALING.md) get
    the same crash-resume guarantee as the single-device path: identical
    results to an uninterrupted sharded run. ``checkpoint_path`` is a
    DIRECTORY of per-process shard files + manifest (multi-host-safe: no
    host ever gathers the full [V,...] state — see parallel/shard_ckpt.py);
    resume works across different mesh shapes and process counts.

    ``stop_after``: simulate a crash for tests — return None once at least
    this many sweeps are checkpointed, leaving the directory resumable.
    """
    from ..checkpoint import (
        check_preempted, run_segment, run_segment_store, stored_slots,
    )
    from ..sampler import init_accum, init_state
    from .shard_ckpt import (
        assemble_draws, latest_step, load_sharded, save_draw_shards,
        save_sharded,
    )

    mesh = mesh or make_mesh()
    n_data = mesh.shape["data"]
    padded, V = pad_positions(np.asarray(counts, np.float32), n_data)
    n_dev = shard_counts(jnp.asarray(padded), mesh)
    eta = None if eta_init is None else jnp.asarray(eta_init, jnp.float32)
    tau0 = (None if tau_init is None
            else jnp.asarray(pad_tau(tau_init, n_data), jnp.int32))

    st_sh = _state_shardings(mesh)
    ac_sh = _accum_shardings(mesh)
    if latest_step(checkpoint_path) is not None:
        state, accum, it, trace_done = load_sharded(
            checkpoint_path, st_sh, ac_sh)
        trace_parts = [trace_done[:it]]
    else:
        state = jax.jit(
            lambda n, k: init_state(n, cfg, k, eta, tau0),
            static_argnames=(), out_shardings=st_sh,
        )(n_dev, key)
        accum = jax.tree_util.tree_map(
            jax.device_put, init_accum(padded.shape[0], padded.shape[1], cfg.G),
            ac_sh,
        )
        it = 0
        trace_parts = []

    while it < cfg.total_sweeps:
        check_preempted()
        if stop_after is not None and it >= stop_after:
            return None  # simulated crash; directory stays resumable
        seg = min(checkpoint_every, cfg.total_sweeps - it)
        if cfg.store_samples:
            state, accum, trace, tau_s, gamma_s, eta_s = run_segment_store(
                n_dev, cfg, state, accum, it, seg, tau_sweep=tau_sweep,
            )
            slots = stored_slots(it, seg, cfg.burn, cfg.store_thin)
            if slots:
                # draws stay sharded: each process persists only its blocks
                # (draws are re-assembled from the shard files at the end)
                j = jnp.asarray(slots)
                save_draw_shards(checkpoint_path, it,
                                 [it + s for s in slots],
                                 tau_s[j], gamma_s[j], eta_s[j])
        else:
            state, accum, trace = run_segment(
                n_dev, cfg, state, accum, it, seg, tau_sweep=tau_sweep,
            )
        it += seg
        trace_parts.append(np.asarray(trace))
        save_sharded(checkpoint_path, state, accum, it,
                     np.concatenate(trace_parts))

    from ..sampler import _result_from_accum

    fields = {}
    if cfg.store_samples:
        Vp, S = padded.shape[0], padded.shape[1]
        _, draws = assemble_draws(
            checkpoint_path,
            shapes={"tau": (Vp, cfg.G), "gamma": (S, cfg.G), "eta": (4, 4)},
            dtypes={"tau": np.int8, "gamma": np.float32, "eta": np.float32},
            upto_it=cfg.total_sweeps,
        )
        if draws:
            fields = {"tau_samples": jnp.asarray(draws["tau"][:, :V]),
                      "gamma_samples": jnp.asarray(draws["gamma"]),
                      "eta_samples": jnp.asarray(draws["eta"])}

    res = _result_from_accum(accum, cfg, jnp.asarray(np.concatenate(trace_parts)))
    res = res._replace(**fields)
    return res._replace(tau_mean=res.tau_mean[:V], tau_star=res.tau_star[:V])


def _state_shardings_chains(mesh: Mesh):
    """Shardings for [C]-leading multi-chain state: chains over 'chain',
    positions over 'data'."""
    from jax.sharding import NamedSharding

    from ..sampler import SamplerState
    from .mesh import CHAIN_AXIS

    def sh(spec):
        return NamedSharding(mesh, spec)

    C = P(CHAIN_AXIS)
    return SamplerState(
        tau=sh(P(CHAIN_AXIS, DATA_AXIS)), gamma=sh(C), eta=sh(C),
        mix=sh(P(CHAIN_AXIS, DATA_AXIS)), loglik=sh(C), key=sh(C),
        kappa_gamma=sh(C), kappa_eta=sh(C),
    )


def _accum_shardings_chains(mesh: Mesh):
    from jax.sharding import NamedSharding

    from ..sampler import SamplerAccum
    from .mesh import CHAIN_AXIS

    def sh(spec):
        return NamedSharding(mesh, spec)

    C = P(CHAIN_AXIS)
    return SamplerAccum(
        sum_tau=sh(P(CHAIN_AXIS, DATA_AXIS)), sum_gamma=sh(C),
        sum_eta=sh(C), sum_loglik=sh(C), n_samples=sh(C),
        star_loglik=sh(C), star_tau=sh(P(CHAIN_AXIS, DATA_AXIS)),
        star_gamma=sh(C), star_eta=sh(C),
        acc_gamma=sh(C), acc_eta=sh(C),
        acc_gamma_post=sh(C), acc_eta_post=sh(C),
    )


def run_chains_sharded_checkpointed(
    counts: np.ndarray,
    cfg: SamplerConfig,
    seeds: Sequence[int],
    checkpoint_path: str,
    checkpoint_every: int = 50,
    mesh: Optional[Mesh] = None,
    eta_init=None,
    tau_init=None,
    tau_sweep=tau_sweep_xla,
    stop_after: Optional[int] = None,
) -> Optional[SamplerResult]:
    """run_chains_sharded with periodic multi-host-safe checkpoints (the
    --mesh x --checkpoint x --chains cell of the CLI capability matrix).

    One shard-checkpoint directory holds every chain's state with a leading
    chain axis sharded over the mesh 'chain' axis (the N-D offset scheme in
    shard_ckpt handles chain x position tiles); the result is bitwise
    identical to run_chains_sharded with the same seeds, interrupted or not,
    and resume may change mesh shape / process count. cfg.store_samples
    composes: thinned draws persist as per-process shard files.
    """
    from jax.sharding import NamedSharding

    from ..checkpoint import (
        check_preempted, run_segment_chains, run_segment_chains_store,
        stored_slots,
    )
    from ..sampler import _result_from_accum, init_accum, init_state
    from .shard_ckpt import (
        assemble_draws, latest_step, load_sharded, save_draw_shards,
        save_sharded,
    )

    mesh = mesh or make_mesh()
    n_data = mesh.shape["data"]
    padded, V = pad_positions(np.asarray(counts, np.float32), n_data)
    n_dev = shard_counts(jnp.asarray(padded), mesh)
    eta = None if eta_init is None else jnp.asarray(eta_init, jnp.float32)
    C = len(seeds)
    Vp, S = padded.shape[0], padded.shape[1]

    st_sh = _state_shardings_chains(mesh)
    ac_sh = _accum_shardings_chains(mesh)
    if latest_step(checkpoint_path) is not None:
        states, accums, it, trace_done = load_sharded(
            checkpoint_path, st_sh, ac_sh)
        trace_parts = [trace_done[:, :it]]
    else:
        keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
        keys_dev = shard_keys(keys, mesh)
        tau0 = (None if tau_init is None
                else jnp.asarray(pad_tau(tau_init, n_data), jnp.int32))
        states = jax.jit(
            jax.vmap(lambda n, k: init_state(n, cfg, k, eta, tau0),
                     in_axes=(None, 0)),
            out_shardings=st_sh,
        )(n_dev, keys_dev)
        accums = jax.tree_util.tree_map(
            lambda x, sh: jax.device_put(
                jnp.broadcast_to(x, (C,) + jnp.shape(x)), sh),
            init_accum(Vp, S, cfg.G), ac_sh,
        )
        it = 0
        trace_parts = []

    rep = NamedSharding(mesh, P())
    while it < cfg.total_sweeps:
        check_preempted()
        if stop_after is not None and it >= stop_after:
            return None  # simulated crash; directory stays resumable
        seg = min(checkpoint_every, cfg.total_sweeps - it)
        if cfg.store_samples:
            states, accums, trace, tau_s, gamma_s, eta_s = (
                run_segment_chains_store(
                    n_dev, cfg, states, accums, it, seg, tau_sweep=tau_sweep,
                ))
            slots = stored_slots(it, seg, cfg.burn, cfg.store_thin)
            if slots:
                j = jnp.asarray(slots)
                # draw-leading layout: per-draw shape (C, ...) so the
                # chain x position offsets key the shard blocks
                save_draw_shards(
                    checkpoint_path, it, [it + s for s in slots],
                    jnp.moveaxis(tau_s[:, j], 1, 0),
                    jnp.moveaxis(gamma_s[:, j], 1, 0),
                    jnp.moveaxis(eta_s[:, j], 1, 0),
                )
        else:
            states, accums, trace = run_segment_chains(
                n_dev, cfg, states, accums, it, seg, tau_sweep=tau_sweep,
            )
        it += seg
        # the [C, seg] trace is chain-sharded; replicate (tiny) so process 0
        # can write the global trace file
        trace_parts.append(np.asarray(jax.device_put(trace, rep)))
        save_sharded(checkpoint_path, states, accums, it,
                     np.concatenate(trace_parts, axis=1))

    fields = {}
    if cfg.store_samples:
        _, draws = assemble_draws(
            checkpoint_path,
            shapes={"tau": (C, Vp, cfg.G), "gamma": (C, S, cfg.G),
                    "eta": (C, 4, 4)},
            dtypes={"tau": np.int8, "gamma": np.float32, "eta": np.float32},
            upto_it=cfg.total_sweeps,
        )
        if draws:  # back to [C, k, ...] with padding stripped
            fields = {
                "tau_samples": jnp.asarray(
                    np.moveaxis(draws["tau"], 0, 1)[:, :, :V]),
                "gamma_samples": jnp.asarray(np.moveaxis(draws["gamma"], 0, 1)),
                "eta_samples": jnp.asarray(np.moveaxis(draws["eta"], 0, 1)),
            }

    trace = jnp.asarray(np.concatenate(trace_parts, axis=1))
    res = jax.vmap(lambda ac, tr: _result_from_accum(ac, cfg, tr))(
        accums, trace
    )._replace(**fields)
    return res._replace(tau_mean=res.tau_mean[:, :V],
                        tau_star=res.tau_star[:, :V])


def run_chain_pt_sharded_checkpointed(
    counts: np.ndarray,
    cfg: SamplerConfig,
    key: jax.Array,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    n_replicas: int = 4,
    max_temp: float = 8.0,
    mesh: Optional[Mesh] = None,
    eta_init=None,
    tau_init=None,
    tau_sweep=tau_sweep_xla,
    stop_after: Optional[int] = None,
) -> Optional[SamplerResult]:
    """Parallel tempering on a (chain, data) mesh with periodic multi-host
    checkpoints (the --pt x --mesh x --checkpoint capability cell, VERDICT r3
    missing #3): long big-V PT runs — the exact regime PT+mesh exists for —
    get the same crash/preemption protection as every other mode.

    The PT ensemble state is an [R]-leading pytree sharded (chain, data), so
    shard_ckpt's N-D offset scheme stores it exactly as it stores a chain
    axis; the PT-specific scalars (rung vector, swap counters) ride the
    extras channel. Results are bitwise identical to an uninterrupted
    run_chain_pt_sharded with the same (key, R, max_temp) because segments
    replay the absolute-sweep-indexed PRNG stream (sampler.make_pt_step).

    ``stop_after``: simulate a crash for tests — return None once at least
    this many sweeps are checkpointed, leaving the directory resumable.
    """
    from ..checkpoint import (
        check_preempted, run_pt_segment, run_pt_segment_store, stored_slots,
    )
    from ..sampler import (
        _result_from_accum, pt_init, pt_merge_accums,
    )
    from .shard_ckpt import (
        assemble_draws, latest_step, load_extras_sharded, load_sharded,
        save_draw_shards, save_sharded,
    )

    R = int(n_replicas)
    if R < 2:  # degenerate ladder: same fallback as run_chain_pt
        return run_chain_sharded_checkpointed(
            counts, cfg, key, checkpoint_path,
            checkpoint_every=checkpoint_every, mesh=mesh, eta_init=eta_init,
            tau_init=tau_init, tau_sweep=tau_sweep, stop_after=stop_after,
        )
    from jax.sharding import NamedSharding

    from .mesh import CHAIN_AXIS

    mesh = mesh or make_mesh()
    n_data = mesh.shape["data"]
    padded, V = pad_positions(np.asarray(counts, np.float32), n_data)
    n_dev = shard_counts(jnp.asarray(padded), mesh)
    eta = None if eta_init is None else jnp.asarray(eta_init, jnp.float32)
    Vp, S = padded.shape[0], padded.shape[1]

    st_sh = _state_shardings_chains(mesh)   # replicas play the chain role
    ac_sh = _accum_shardings_chains(mesh)
    rep = NamedSharding(mesh, P())
    if latest_step(checkpoint_path) is not None:
        states, accums, it, trace_done = load_sharded(
            checkpoint_path, st_sh, ac_sh)
        ex = load_extras_sharded(checkpoint_path)
        rung = jax.device_put(jnp.asarray(ex["rung"]), rep)
        acc_sum = float(ex["acc_sum"])
        head_sum = float(ex["head_sum"])
        trace_parts = [trace_done[:it]]
    else:
        tau0 = (None if tau_init is None
                else jnp.asarray(pad_tau(tau_init, n_data), jnp.int32))
        states, accums, rung = jax.jit(
            lambda n, k: pt_init(
                n, cfg, k, R, eta_init=eta, tau_init=tau0,
                replica_sharding=NamedSharding(mesh, P(CHAIN_AXIS, None)),
            ),
            out_shardings=(st_sh, ac_sh, rep),
        )(n_dev, key)
        it, acc_sum, head_sum = 0, 0.0, 0.0
        trace_parts = []

    while it < cfg.total_sweeps:
        check_preempted()
        if stop_after is not None and it >= stop_after:
            return None  # simulated crash; directory stays resumable
        seg = min(checkpoint_every, cfg.total_sweeps - it)
        if cfg.store_samples:
            (states, accums, rung, trace, n_acc, n_heads,
             tau_s, gamma_s, eta_s) = run_pt_segment_store(
                n_dev, cfg, key, states, accums, rung, it, seg, max_temp,
                tau_sweep=tau_sweep,
            )
            slots = stored_slots(it, seg, cfg.burn, cfg.store_thin)
            if slots:  # cold-rung draws persist shard-locally
                j = jnp.asarray(slots)
                save_draw_shards(checkpoint_path, it, [it + s for s in slots],
                                 tau_s[j], gamma_s[j], eta_s[j])
        else:
            states, accums, rung, trace, n_acc, n_heads = run_pt_segment(
                n_dev, cfg, key, states, accums, rung, it, seg, max_temp,
                tau_sweep=tau_sweep,
            )
        it += seg
        acc_sum += float(n_acc)
        head_sum += float(n_heads)
        trace_parts.append(np.asarray(jax.device_put(trace, rep)))
        save_sharded(checkpoint_path, states, accums, it,
                     np.concatenate(trace_parts),
                     extras={"rung": np.asarray(jax.device_put(rung, rep)),
                             "acc_sum": acc_sum, "head_sum": head_sum})

    fields = {}
    if cfg.store_samples:
        _, draws = assemble_draws(
            checkpoint_path,
            shapes={"tau": (Vp, cfg.G), "gamma": (S, cfg.G), "eta": (4, 4)},
            dtypes={"tau": np.int8, "gamma": np.float32, "eta": np.float32},
            upto_it=cfg.total_sweeps,
        )
        if draws:
            fields = {"tau_samples": jnp.asarray(draws["tau"][:, :V]),
                      "gamma_samples": jnp.asarray(draws["gamma"]),
                      "eta_samples": jnp.asarray(draws["eta"])}

    accum = pt_merge_accums(accums)
    swap_rate = jnp.float32(acc_sum / max(head_sum, 1.0))
    res = _result_from_accum(
        accum, cfg, jnp.asarray(np.concatenate(trace_parts)),
        pt_swap_accept=swap_rate, **fields,
    )
    return res._replace(tau_mean=res.tau_mean[:V], tau_star=res.tau_star[:V])


def run_chain_pt_sharded(
    counts: np.ndarray,
    cfg: SamplerConfig,
    key: jax.Array,
    n_replicas: int = 4,
    max_temp: float = 8.0,
    mesh: Optional[Mesh] = None,
    eta_init=None,
    tau_init=None,
    tau_sweep=tau_sweep_xla,
) -> SamplerResult:
    """Parallel tempering on a (chain, data) mesh: replicas shard over the
    chain axis, positions over the data axis. The temperature-swap exchange
    (sampler.run_chain_pt) moves only R scalars, so replicas never exchange
    state across the mesh — per-sweep communication stays the same few-KB
    psum of gamma/eta statistics as the plain sharded run."""
    from jax.sharding import NamedSharding

    from ..sampler import run_chain_pt
    from .mesh import CHAIN_AXIS

    mesh = mesh or make_mesh()
    n_data = mesh.shape["data"]
    padded, V = pad_positions(np.asarray(counts, np.float32), n_data)
    n_dev = shard_counts(jnp.asarray(padded), mesh)
    eta = None if eta_init is None else jnp.asarray(eta_init, jnp.float32)

    tau0 = (None if tau_init is None
            else jnp.asarray(pad_tau(tau_init, n_data), jnp.int32))
    res = run_chain_pt(
        n_dev, cfg, key, n_replicas=n_replicas, max_temp=max_temp,
        eta_init=eta, tau_init=tau0, tau_sweep=tau_sweep,
        replica_sharding=NamedSharding(mesh, P(CHAIN_AXIS, None)),
    )
    res = res._replace(tau_mean=res.tau_mean[:V], tau_star=res.tau_star[:V])
    if res.tau_samples is not None:  # stored draws carry the padding too
        res = res._replace(tau_samples=res.tau_samples[:, :V])
    return res
