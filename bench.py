"""Benchmark: Gibbs sweeps/sec/chip at the BASELINE.json north-star config.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Config (BASELINE.json "metric"): V=1e4 variant positions x S=64 samples x
G=8 strains. value = full Gibbs sweeps (tau exact update + gamma MH + eta MH
+ loglik) per second on one GPU on the default (XLA) path, steady-state
(compile excluded; the whole run is one device program). Needs a GPU: on
any other backend it exits non-zero. The line before the JSON names the
device and the card's power limit.

vs_baseline: ratio against the reference's single-core CPU sampler. The
reference mount was empty (SURVEY.md provenance warning), so the baseline is
desman_tpu/baseline_numpy.py — the same O(V*G*4*S) sweep in vectorized
numpy restricted to one BLAS thread, measured here on the same host; if
anything faster than the reference's per-draw Cython+GSL loop, so the
reported ratio is conservative. Target: >= 10x (BASELINE.md).
"""
import json
import os
import sys
import time

# single-thread the baseline BLAS before numpy import
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")

import numpy as np

V, S, G = 10_000, 64, 8
SWEEPS = 400          # per timed chain; compile excluded, median of 3
BASELINE_SWEEPS = 2


def main():
    import subprocess

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU; JAX found platform {dev.platform!r}",
              file=sys.stderr)
        raise SystemExit(1)
    from desman_tpu import synth
    from desman_tpu.sampler import SamplerConfig, run_chain
    from desman_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    print(f"# device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} card={'; '.join(card)}")

    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
    n_host = t.data.counts.astype(np.float32)
    n = jax.device_put(jnp.asarray(n_host), dev)
    cfg = SamplerConfig(G=G, burn=0, samples=SWEEPS, nmf_iters=50)
    prog = jax.jit(lambda n, k: run_chain(n, cfg, k))
    res = prog(n, jax.random.PRNGKey(0))   # compile + run
    trace = np.asarray(res.loglik_trace)   # device->host fetch forces completion
    times = []
    for i in range(3):
        t0 = time.time()
        res = prog(n, jax.random.PRNGKey(i + 1))
        trace = np.asarray(res.loglik_trace)
        times.append(time.time() - t0)
    elapsed = sorted(times)[len(times) // 2]  # median
    sweeps_per_s = SWEEPS / elapsed
    print(f"# gpu: {SWEEPS} sweeps x3, times {['%.3f' % t for t in times]} "
          f"-> {sweeps_per_s:.2f} sweeps/s", file=sys.stderr)
    print(f"# final loglik: {float(trace[-1]):.1f}", file=sys.stderr)

    # --- single-core numpy baseline (reference sampler stand-in) ---
    from desman_tpu import baseline_numpy

    rng = np.random.default_rng(0)
    tau = rng.integers(0, 4, size=(V, G))
    gamma = rng.dirichlet(np.ones(G), size=S)
    eta = np.full((4, 4), 0.01 / 3) + np.eye(4) * (0.99 - 0.01 / 3)
    nb = n_host.astype(np.float64)
    baseline_numpy.sweep(nb, tau.copy(), gamma.copy(), eta.copy(),
                         np.random.default_rng(1))  # warm caches
    t0 = time.time()
    r = np.random.default_rng(2)
    for _ in range(BASELINE_SWEEPS):
        tau, gamma, eta, ll = baseline_numpy.sweep(nb, tau, gamma, eta, r)
    base_elapsed = time.time() - t0
    base_sweeps_per_s = BASELINE_SWEEPS / base_elapsed
    print(f"# baseline (1-core numpy): {BASELINE_SWEEPS} sweeps in "
          f"{base_elapsed:.3f}s -> {base_sweeps_per_s:.2f} sweeps/s",
          file=sys.stderr)

    print(json.dumps({
        "metric": "gibbs_sweeps_per_sec_per_chip_V1e4_S64_G8",
        "value": round(sweeps_per_s, 3),
        "unit": "sweeps/s",
        "vs_baseline": round(sweeps_per_s / base_sweeps_per_s, 2),
    }))


if __name__ == "__main__":
    main()
