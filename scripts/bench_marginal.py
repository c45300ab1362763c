"""Marginal per-sweep component costs via two-length differencing.

Every device program carries a fixed launch cost, so timing an N-iteration
loop and dividing by N overstates the per-iteration cost. This harness runs
each component inside jitted fori_loops of two lengths and reports
`(T(hi) - T(lo)) / (hi - lo)` — the launch cost cancels exactly.

Produces a per-component cost table and full-sweep config ablations. Needs
a GPU (it refuses any other backend): `python scripts/bench_marginal.py`.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from desman_tpu import synth
    from desman_tpu.likelihood import mixture
    from desman_tpu.ops import tau_sweep_pallas
    from desman_tpu.sampler import (
        SamplerConfig, _loglik, eta_step, eta_step_joint, gamma_step,
        init_accum, init_state, make_sweep_fn, tau_sweep_xla, tau_swap_move,
    )
    from desman_tpu.utils import one_hot_tau

    V, S, G = 10_000, 64, 8
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_marginal: needs a GPU; JAX found platform "
              f"{dev.platform!r}", file=sys.stderr)
        raise SystemExit(1)
    print(f"# device: {dev.platform} {dev.device_kind}", file=sys.stderr)
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
    n = jnp.asarray(t.data.counts, jnp.float32)
    rng = np.random.default_rng(0)
    tau = jnp.asarray(rng.integers(0, 4, size=(V, G)), jnp.int32)
    gamma = jnp.asarray(rng.dirichlet(np.ones(G), size=S), jnp.float32)
    eta = jnp.asarray(synth.make_eta(0.01), jnp.float32)
    mix0 = mixture(one_hot_tau(tau), gamma)
    cfg = SamplerConfig(G=G)
    key = jax.random.PRNGKey(0)
    ll0 = _loglik(n, mix0, eta)

    def run_loop(fn, iters):
        # thread mix through the carry so the component can't be hoisted
        def body(i, mix):
            return fn(jax.random.fold_in(key, i), mix)
        f = jax.jit(lambda m: jax.lax.fori_loop(0, iters, body, m))
        jax.block_until_ready(f(mix0))
        ts = []
        for _ in range(3):
            t0 = time.time()
            jax.block_until_ready(f(mix0))
            ts.append(time.time() - t0)
        return sorted(ts)[1]

    def marginal(name, fn, lo=30, hi=300):
        tlo, thi = run_loop(fn, lo), run_loop(fn, hi)
        m = (thi - tlo) / (hi - lo)
        fixed = tlo - lo * m
        print(f"{name:30s} {m * 1e3:7.3f} ms/it (fixed launch {fixed * 1e3:5.1f} ms)")

    marginal("tau_sweep_pallas",
             lambda k, m: tau_sweep_pallas(n, tau, m, gamma, eta, k)[1])
    marginal("tau_sweep_pallas+fused_swap",
             lambda k, m: tau_sweep_pallas(
                 n, tau, m, gamma, eta, k,
                 swap_key=jax.random.fold_in(k, 12345))[1])
    marginal("tau_sweep_xla",
             lambda k, m: tau_sweep_xla(n, tau, m, gamma, eta, k)[1])
    marginal("swap_move_xla",
             lambda k, m: tau_swap_move(n, tau, m, gamma, eta, k)[1])
    marginal("gamma_step",
             lambda k, m: gamma_step(cfg, n, tau, m, gamma, eta, k)[1])
    marginal("eta_step_rows",
             lambda k, m: m + eta_step(cfg, n, m, eta, ll0, k)[1] * 1e-30)
    marginal("eta_step_joint",
             lambda k, m: m + eta_step_joint(cfg, n, m, eta, ll0, k)[1] * 1e-30)
    marginal("loglik_pass",
             lambda k, m: m + _loglik(n, m, eta) * 1e-30)

    # full-sweep ablations through make_sweep_fn (the production scan body)
    def sweep_marginal(name, cfgkw, lo=30, hi=300):
        c = SamplerConfig(G=G, burn=0, samples=hi, **cfgkw)
        sweep = make_sweep_fn(c, tau_sweep=tau_sweep_pallas)
        state = init_state(n, c, key)
        accum = init_accum(V, S, G)
        jax.block_until_ready(state.mix)

        def make(iters):
            @jax.jit
            def f(state, accum):
                def body(carry, it):
                    st, ac = carry
                    st, ac, ll = sweep(n, st, ac, it)
                    return (st, ac), ll
                return jax.lax.scan(body, (state, accum), jnp.arange(iters))
            jax.block_until_ready(f(state, accum)[1])
            ts = []
            for _ in range(3):
                t0 = time.time()
                jax.block_until_ready(f(state, accum)[1])
                ts.append(time.time() - t0)
            return sorted(ts)[1]

        m = (make(hi) - make(lo)) / (hi - lo)
        print(f"{name:30s} {m * 1e3:7.3f} ms/sweep ({1 / m:6.0f} sweeps/s)")

    sweep_marginal("full sweep (default cfg)", {})
    sweep_marginal("full sweep (eta rows)", dict(eta_update="rows"))
    sweep_marginal("full sweep (no swap)", dict(swap_moves=False))


if __name__ == "__main__":
    main()
