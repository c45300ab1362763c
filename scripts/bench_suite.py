"""Whole-surface benchmark suite (beyond bench.py's single north-star line).

Measures every hot path on one GPU (it refuses any other backend) and
prints one JSON line per entry plus a markdown table for PERF.md. bench.py
remains the single-number entry point; this suite is for tracking the rest
of the framework:

  full_sweep            V=1e4 x S=64 x G=8 Gibbs sweep (pallas + xla paths)
  full_sweep_chains4    4 vmapped chains, aggregate sweeps/s/GPU
  full_sweep_scale      V=1e5 x S=96 x G=16 (BASELINE config #5, one GPU)
  convergence           time to within 0.01% of star loglik (north-star cfg)
  filter                variant filter throughput, V=1e5 x S=64 (positions/s)
  geneassign            exact-enumeration gene assignment, D=5e3 x G=8 (genes/s)
  extract_native/python mpileup parsing throughput (MB/s)
  csv_native/python     counts-CSV ingestion throughput (MB/s)

Run from the repo root:  python scripts/bench_suite.py [--quick]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _median_time(fn, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.time()
        fn()
        times.append(time.time() - t0)
    return sorted(times)[len(times) // 2]


def bench_sweeps(results, quick):
    import jax
    import jax.numpy as jnp
    from functools import partial

    from desman_tpu import synth
    from desman_tpu.sampler import SamplerConfig, run_chain, run_chains

    sweeps = 30 if quick else 100

    def one(name, V, S, G, kernel, chains=None):
        t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
        n = jnp.asarray(t.data.counts, jnp.float32)
        cfg = SamplerConfig(G=G, burn=0, samples=sweeps, nmf_iters=30)
        sweep_fn = None
        if kernel == "pallas":
            from desman_tpu.ops import tau_sweep_pallas

            sweep_fn = tau_sweep_pallas
        runner = (partial(run_chain, tau_sweep=sweep_fn) if sweep_fn
                  else run_chain)

        if chains:
            seeds = list(range(chains))
            kw = {"tau_sweep": sweep_fn} if sweep_fn else {}

            def go(i=[0]):
                i[0] += 1
                r = run_chains(n, cfg, [s + i[0] for s in seeds], **kw)
                np.asarray(r.mean_loglik)
        else:
            def go(i=[0]):
                i[0] += 1
                r = runner(n, cfg, jax.random.PRNGKey(i[0]))
                np.asarray(r.loglik_trace)

        go()  # compile
        el = _median_time(go)
        total = sweeps * (chains or 1)
        results.append({
            "bench": name, "value": round(total / el, 2), "unit": "sweeps/s",
            "config": f"V={V} S={S} G={G}" + (f" chains={chains}" if chains else ""),
        })

    one("full_sweep_xla", 10_000, 64, 8, "xla")
    one("full_sweep_pallas", 10_000, 64, 8, "pallas")
    one("full_sweep_chains4", 10_000, 64, 8, "xla", chains=4)
    if not quick:
        one("full_sweep_scale_xla", 100_000, 96, 16, "xla")
        one("full_sweep_scale_pallas", 100_000, 96, 16, "pallas")


def bench_convergence(results, quick):
    """Time-to-converged-deviance at the north-star config (BASELINE.md):
    sweeps and seconds until the trace reaches within 0.01% of the run's
    star (best) loglik. The plateau sits ~1e-4 relative BELOW the truth's
    loglik (posterior gamma/eta jitter around ML over ~3e7 reads), so the
    star-relative target is the meaningful one; the run also asserts the
    star haplotypes match the generating truth exactly."""
    import jax
    import jax.numpy as jnp

    from desman_tpu import synth
    from desman_tpu.sampler import SamplerConfig, run_chain
    from desman_tpu.utils import snp_distance_perm

    V, S, G = (2_000, 16, 4) if quick else (10_000, 64, 8)
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
    n = jnp.asarray(t.data.counts, jnp.float32)

    sweeps = 150 if quick else 300
    cfg = SamplerConfig(G=G, burn=sweeps // 2, samples=sweeps - sweeps // 2,
                        nmf_iters=50)
    run_chain(n, cfg, jax.random.PRNGKey(0))  # compile
    t0 = time.time()
    res = run_chain(n, cfg, jax.random.PRNGKey(1))
    trace = np.asarray(res.loglik_trace)
    elapsed = time.time() - t0
    snp = snp_distance_perm(t.tau_idx, np.asarray(res.tau_star))
    star = float(res.star_loglik)
    target = star - 1e-4 * abs(star)
    hit = np.flatnonzero(trace >= target)
    sweeps_to = int(hit[0]) + 1 if hit.size else -1
    secs = sweeps_to * elapsed / sweeps if sweeps_to > 0 else -1.0
    results.append({
        "bench": "time_to_converged_deviance",
        "value": round(secs, 3), "unit": "s",
        "config": f"V={V} S={S} G={G}; {sweeps_to} sweeps to within 0.01% "
                  f"of star loglik; star-vs-truth SNP errors={snp}",
    })


def bench_filter(results, quick):
    import jax

    from desman_tpu import synth
    from desman_tpu.filter import FilterConfig, filter_variants

    V = 20_000 if quick else 100_000
    t = synth.generate(V=V, S=64, G=4, coverage=50.0, seed=1)

    def go():
        r = filter_variants(t.data, FilterConfig())
        np.asarray(r.selected)

    go()
    el = _median_time(go)
    results.append({"bench": "filter", "value": round(V / el, 1),
                    "unit": "positions/s", "config": f"V={V} S=64"})


def bench_geneassign(results, quick):
    from desman_tpu.geneassign import GeneAssignConfig, assign_genes

    D, G, S = (1000, 8, 64) if quick else (5000, 8, 64)
    rng = np.random.default_rng(0)
    gamma = rng.dirichlet(np.ones(G), size=S)
    cov = (gamma * 40.0).T
    etaG = rng.integers(0, 2, size=(D, G))
    x = rng.poisson(etaG @ cov).astype(np.float64)

    def go():
        r = assign_genes(x, cov, GeneAssignConfig(max_copy=1))
        np.asarray(r.eta_star)

    go()
    el = _median_time(go)
    results.append({"bench": "geneassign_enum", "value": round(D / el, 1),
                    "unit": "genes/s", "config": f"D={D} G={G} S={S} states=256"})


def bench_io(results, quick, tmpdir):
    from desman_tpu import io, native, synth
    from desman_tpu.pileup import read_pileup_py, write_pileup

    V = 5_000 if quick else 20_000
    t = synth.generate(V=V, S=32, G=4, coverage=50.0, seed=2)

    csv_path = os.path.join(tmpdir, "bench_counts.csv")
    io.write_counts_csv(csv_path, t.data)
    mb = os.path.getsize(csv_path) / 1e6
    if native.available():
        el = _median_time(lambda: native.read_counts_csv_native(csv_path))
        results.append({"bench": "csv_native", "value": round(mb / el, 1),
                        "unit": "MB/s", "config": f"{mb:.1f} MB"})
    el = _median_time(lambda: io.read_counts_csv(csv_path, prefer_native=False))
    results.append({"bench": "csv_python", "value": round(mb / el, 1),
                    "unit": "MB/s", "config": f"{mb:.1f} MB"})

    pl_path = os.path.join(tmpdir, "bench.pileup")
    write_pileup(pl_path, t.data)
    mb = os.path.getsize(pl_path) / 1e6
    if native.pileup_available():
        el = _median_time(lambda: native.read_pileup_native(pl_path))
        results.append({"bench": "extract_native", "value": round(mb / el, 1),
                        "unit": "MB/s", "config": f"{mb:.1f} MB"})
    el = _median_time(lambda: read_pileup_py(pl_path))
    results.append({"bench": "extract_python", "value": round(mb / el, 1),
                    "unit": "MB/s", "config": f"{mb:.1f} MB"})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma list: sweeps,convergence,filter,geneassign,io")
    args = ap.parse_args()

    import tempfile

    import jax

    from desman_tpu.utils import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_suite: needs a GPU; JAX found platform "
              f"{dev.platform!r}", file=sys.stderr)
        raise SystemExit(1)
    enable_compilation_cache()  # big-V compiles take minutes; cache them
    print(f"# device: {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}", file=sys.stderr)
    results = []
    todo = (args.only or "sweeps,convergence,filter,geneassign,io").split(",")
    with tempfile.TemporaryDirectory() as td:
        if "sweeps" in todo:
            bench_sweeps(results, args.quick)
        if "convergence" in todo:
            bench_convergence(results, args.quick)
        if "filter" in todo:
            bench_filter(results, args.quick)
        if "geneassign" in todo:
            bench_geneassign(results, args.quick)
        if "io" in todo:
            bench_io(results, args.quick, td)

    for r in results:
        print(json.dumps(r))
    print("\n| bench | value | unit | config |", file=sys.stderr)
    print("|---|---|---|---|", file=sys.stderr)
    for r in results:
        print(f"| {r['bench']} | {r['value']} | {r['unit']} | {r['config']} |",
              file=sys.stderr)


if __name__ == "__main__":
    main()
