"""GPU smoke test: the DESMAN pipeline through its CLI, and the tau kernel
against its XLA reference at full width.

    python chip_smoke.py          # phases A and B on one GPU
    python chip_smoke.py --four   # phase C only, on four GPUs
    python chip_smoke.py --tune   # tau-kernel launch-shape sweep only

Phase A  E. coli-mock shape (examples/complete_example.py --paper): V=7000
         biallelic SNVs + 7000 monomorphic positions, S=64, true G=5.
         filter -> desman G in {4,5,6} x seeds {0,1} at 250 sweeps ->
         resolvenhap -> validate, each through desman_tpu.cli.main.
         Gates: selected G == 5, SNP error rate <= 0.1 %, gamma MAE <= 0.005.
Phase B  The sampler at V=1e4/S=64/G=8 and V=1e5/S=96/G=16: 100-sweep
         chains on the XLA path and the Pallas kernel path, timed in turns;
         the kernel against tau_sweep_xla (HIGHEST-precision einsums) for
         one sweep from the same state and noise (>= 99.9 % identical draws,
         mixture within rtol 1e-5 / atol 1e-6 on agreeing rows) and for
         60-sweep chains (tau_star agreement >= 0.99, final loglik relative
         difference <= 1e-4).
Phase C  desman --mesh 1x4 at V=1e5/S=96/G=16 against the one-GPU run of
         the same seed, on the XLA path and the kernel path (tau_star
         agreement >= 0.99, final loglik relative difference <= 1e-4).

Everything runs in this one process (a second JAX process on a GPU would
find its memory taken). Data comes from desman_tpu.synth under --seed.
The card's name and power limit are printed first; the last line is the
device JSON, printed only when every phase passed. Without a GPU the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import io as _stdio
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")

# Phase B shapes: the north-star config and BASELINE config #5
SHAPES = ((10_000, 64, 8), (100_000, 96, 16))


class GateError(AssertionError):
    """A phase ran but missed one of its gates."""


def _gate(ok: bool, what: str) -> None:
    print(f"  gate {'PASS' if ok else 'FAIL'}: {what}", flush=True)
    if not ok:
        raise GateError(what)


def card_lines() -> list:
    """`nvidia-smi --query-gpu=name,power.limit` lines, one per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _cli(argv, capture=False):
    """desman_tpu.cli.main in-process; raises on a non-zero exit."""
    from desman_tpu import cli

    buf = _stdio.StringIO()
    with contextlib.redirect_stdout(buf) if capture else contextlib.nullcontext():
        rc = cli.main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"desman {' '.join(map(str, argv))} exited {rc}")
    return buf.getvalue()


# --------------------------------------------------------------------------
# Phase A: the pipeline at paper scale through the CLI
# --------------------------------------------------------------------------

def phase_a(workdir, V=7000, S=64, G_true=5, g_values=(4, 5, 6),
            seeds=(0, 1), iterations=250, seed=2017,
            max_snp_error=0.001, max_gamma_mae=0.005) -> dict:
    from desman_tpu import io, synth

    os.makedirs(workdir, exist_ok=True)
    t = synth.generate(V=V, S=S, G=G_true, coverage=50.0, error_rate=0.005,
                       gamma_alpha=0.6, seed=seed, max_alleles=2)
    rng = np.random.default_rng(seed)
    mono_base = rng.integers(0, 4, size=V)
    mono = rng.poisson(
        50.0 * t.eta[mono_base][:, None, :].repeat(S, axis=1)
    ).astype(np.int32)
    full = io.CountsData(
        counts=np.concatenate([t.data.counts, mono], axis=0),
        contigs=np.array(["synth"] * (2 * V)), positions=np.arange(2 * V),
        samples=t.data.samples,
    )
    counts = os.path.join(workdir, "core_counts.csv")
    truth_tau = os.path.join(workdir, "truth_tau.csv")
    truth_gamma = os.path.join(workdir, "truth_gamma.csv")
    io.write_counts_csv(counts, full)
    io.write_tau_star_csv(truth_tau, t.tau_idx, np.array(["synth"] * V),
                          np.arange(V))
    io.write_gamma_csv(truth_gamma, t.gamma, t.data.samples)
    print(f"phase A: {V} variant + {V} monomorphic positions, S={S}, "
          f"true G={G_true}; grid G={list(g_values)} x seeds={list(seeds)} "
          f"at {iterations} sweeps", flush=True)

    stub = os.path.join(workdir, "filtered_")
    t0 = time.time()
    _cli(["filter", counts, "-o", stub])
    filter_s = time.time() - t0
    elapsed = {}
    for G in g_values:
        for s in seeds:
            out = os.path.join(workdir, f"run_{G}_{s}")
            _cli(["desman", stub + "sel_var.csv", "-g", G, "-e",
                  stub + "tran_df.csv", "-o", out, "-i", iterations,
                  "-s", s])
            with open(os.path.join(out, "metrics.json")) as f:
                elapsed[(G, s)] = json.load(f)["elapsed_s"]
    best = os.path.join(workdir, "best.txt")
    _cli(["resolvenhap", os.path.join(workdir, "run_*"), "-o", best],
         capture=True)
    with open(best) as f:
        row = f.read().splitlines()[1].split(",")
    G_sel, run_dir = int(row[0]), row[4]
    line = _cli(["validate",
                 "-p", os.path.join(run_dir, "Filtered_Tau_star.csv"),
                 "-t", truth_tau,
                 "--pred_gamma", os.path.join(run_dir, "Gamma_mean.csv"),
                 "--true_gamma", truth_gamma], capture=True)
    fields = line.strip().splitlines()[-1].split(",")
    snp_errors, error_rate = int(fields[2]), float(fields[3])
    gamma_mae = float(fields[4])

    # the first seed of each G compiles; later seeds reuse the executable
    first = [elapsed[(G, seeds[0])] for G in g_values]
    warm = [elapsed[(G, s)] for G in g_values for s in seeds[1:]]
    res = {
        "selected_G": G_sel, "snp_errors": snp_errors,
        "snp_error_rate": error_rate, "gamma_mae": gamma_mae,
        "filter_s": filter_s,
        "first_run_s": first,
        "compile_s": (sum(first) - sum(warm) / (len(seeds) - 1)
                      if warm else None),
        "warm_run_s": (sum(warm) / len(warm)) if warm else None,
        "warm_sweeps_per_s": (iterations * len(warm) / sum(warm)
                              if warm else None),
        "peak_bytes_in_use": peak_bytes(),
    }
    print(f"phase A: {json.dumps(res)}", flush=True)
    _gate(G_sel == G_true, f"selected G {G_sel} == true G {G_true}")
    _gate(error_rate <= max_snp_error,
          f"SNP error rate {error_rate} <= {max_snp_error}")
    _gate(gamma_mae <= max_gamma_mae,
          f"gamma MAE {gamma_mae} <= {max_gamma_mae}")
    return res


# --------------------------------------------------------------------------
# Phase B: the sampler at scale, kernel against reference
# --------------------------------------------------------------------------

def _timed_compile(fn, *args):
    t0 = time.time()
    compiled = fn.lower(*args).compile()
    return compiled, time.time() - t0


def _block(x):
    import jax

    return jax.block_until_ready(x)


def phase_b(V, S, G, sweeps=100, chain_sweeps=60, reps=3, seed=0,
            kernel=True, interpret=False) -> dict:
    import jax
    import jax.numpy as jnp
    from functools import partial

    from desman_tpu import synth
    from desman_tpu.likelihood import mixture
    from desman_tpu.ops.tau_pallas import tau_sweep_pallas
    from desman_tpu.sampler import (
        SamplerConfig, run_chain, tau_swap_move, tau_sweep_xla,
    )
    from desman_tpu.utils import one_hot_tau

    tag = f"V={V} S={S} G={G}"
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=seed)
    n = jnp.asarray(t.data.counts, jnp.float32)
    kern = partial(tau_sweep_pallas, interpret=interpret)
    paths = {"xla": tau_sweep_xla}
    if kernel:
        paths["pallas"] = kern
    res = {"shape": [V, S, G]}

    if kernel:
        # one sweep from the same state with the same Gumbel noise
        rng = np.random.default_rng(seed)
        tau0 = jnp.asarray(rng.integers(0, 4, size=(V, G)), jnp.int32)
        gamma = jnp.asarray(t.gamma, jnp.float32)
        eta = jnp.asarray(t.eta, jnp.float32)
        mix0 = mixture(one_hot_tau(tau0), gamma)
        key = jax.random.PRNGKey(seed + 1)
        ks = jax.random.fold_in(key, 12345)

        def xla_swap(n, tau, mix, gamma, eta, key, ks):
            tau, mix = tau_sweep_xla(n, tau, mix, gamma, eta, key)
            return tau_swap_move(n, tau, mix, gamma, eta, ks)

        def kern_swap(n, tau, mix, gamma, eta, key, ks):
            return kern(n, tau, mix, gamma, eta, key, swap_key=ks)

        args = (n, tau0, mix0, gamma, eta, key)
        tx, mx = _block(jax.jit(tau_sweep_xla)(*args))
        tk, mk = _block(jax.jit(kern)(*args))
        tx, mx, tk, mk = map(np.asarray, (tx, mx, tk, mk))
        same = tx == tk
        rows = same.all(axis=1)
        res["sweep_draw_agreement"] = float(same.mean())
        res["sweep_mix_max_abs_diff"] = float(
            np.abs(mk[rows] - mx[rows]).max()) if rows.any() else None
        mix_ok = bool(np.allclose(mk[rows], mx[rows], rtol=1e-5, atol=1e-6))

        # the swap epilogue against sweep + tau_swap_move, and the layer's
        # own time (tau sweep + swap, one jitted call each)
        sargs = args + (ks,)
        layer = {}
        outs = {}
        for name, fn in (("xla", xla_swap), ("pallas", kern_swap)):
            c, _ = _timed_compile(jax.jit(fn), *sargs)
            outs[name] = _block(c(*sargs))
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                _block(c(*sargs))
                times.append(time.perf_counter() - t0)
            layer[name] = float(np.median(times))
        res["swap_draw_agreement"] = float(
            (np.asarray(outs["xla"][0]) == np.asarray(outs["pallas"][0])).mean())
        res["tau_swap_layer_ms"] = {k: v * 1e3 for k, v in layer.items()}

    # full chains: compile, then time the paths in turns
    cfg = SamplerConfig(G=G, burn=sweeps // 2, samples=sweeps - sweeps // 2,
                        nmf_iters=50)
    key = jax.random.PRNGKey(seed)
    def chain_prog(sweep):
        return jax.jit(lambda n, k: run_chain(n, cfg, k, tau_sweep=sweep))

    progs, compile_s = {}, {}
    for name, sweep in paths.items():
        progs[name], compile_s[name] = _timed_compile(chain_prog(sweep), n,
                                                      key)
    times = {name: [] for name in paths}
    order = list(paths)
    for r in range(reps):
        for name in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            out = progs[name](n, jax.random.PRNGKey(100 + r))
            _block(out.loglik_trace)
            times[name].append(time.perf_counter() - t0)
            if not np.isfinite(np.asarray(out.loglik_trace)).all():
                raise GateError(f"{tag} {name}: non-finite loglik trace")
    res["compile_s"] = compile_s
    res["chain_s"] = {k: float(np.median(v)) for k, v in times.items()}
    res["sweeps_per_s"] = {k: sweeps / res["chain_s"][k] for k in times}

    if kernel:
        cfg60 = SamplerConfig(G=G, burn=chain_sweeps // 2,
                              samples=chain_sweeps - chain_sweeps // 2,
                              nmf_iters=50)
        chains = {name: run_chain(n, cfg60, key, tau_sweep=sweep)
                  for name, sweep in paths.items()}
        ts_x = np.asarray(chains["xla"].tau_star)
        ts_k = np.asarray(chains["pallas"].tau_star)
        ll_x = float(np.asarray(chains["xla"].loglik_trace)[-1])
        ll_k = float(np.asarray(chains["pallas"].loglik_trace)[-1])
        res["chain_tau_star_agreement"] = float((ts_x == ts_k).mean())
        res["chain_loglik_rel_diff"] = abs(ll_k - ll_x) / abs(ll_x)
    res["peak_bytes_in_use"] = peak_bytes()
    print(f"phase B {tag}: {json.dumps(res)}", flush=True)
    if kernel:
        _gate(res["sweep_draw_agreement"] >= 0.999,
              f"{tag} one-sweep draw agreement "
              f"{res['sweep_draw_agreement']} >= 0.999")
        _gate(mix_ok, f"{tag} mixture on agreeing rows within rtol 1e-5 / "
              f"atol 1e-6 (max abs diff {res['sweep_mix_max_abs_diff']})")
        _gate(res["swap_draw_agreement"] >= 0.999,
              f"{tag} swap-epilogue draw agreement "
              f"{res['swap_draw_agreement']} >= 0.999")
        _gate(res["chain_tau_star_agreement"] >= 0.99,
              f"{tag} 60-sweep tau_star agreement "
              f"{res['chain_tau_star_agreement']} >= 0.99")
        _gate(res["chain_loglik_rel_diff"] <= 1e-4,
              f"{tag} 60-sweep final loglik rel diff "
              f"{res['chain_loglik_rel_diff']} <= 1e-4")
    return res


# --------------------------------------------------------------------------
# Phase C: position sharding through the CLI (--four)
# --------------------------------------------------------------------------

def phase_c(workdir, V=100_000, S=96, G=16, iterations=100, seed=0,
            mesh="1x4", kernels=("xla", "pallas")) -> dict:
    from desman_tpu import io, synth

    os.makedirs(workdir, exist_ok=True)
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=seed)
    counts = os.path.join(workdir, "counts.csv")
    io.write_counts_csv(counts, t.data)
    print(f"phase C: V={V} S={S} G={G}, {iterations} sweeps, --mesh {mesh} "
          f"vs one device, kernels {list(kernels)}", flush=True)
    res = {}
    for kernel in kernels:
        runs = {}
        for where, extra in (("one", []), ("mesh", ["--mesh", mesh])):
            out = os.path.join(workdir, f"{where}_{kernel}")
            _cli(["desman", counts, "-g", G, "-i", iterations, "-s", seed,
                  "-o", out, "--kernel", kernel] + extra)
            tau, _, _ = io.read_tau_star_csv(
                os.path.join(out, "Filtered_Tau_star.csv"))
            with open(os.path.join(out, "metrics.json")) as f:
                m = json.load(f)
            runs[where] = (tau, m["final_loglik"], m["elapsed_s"])
        (tau1, ll1, s1), (tau4, ll4, s4) = runs["one"], runs["mesh"]
        r = {"tau_star_agreement": float((tau1 == tau4).mean()),
             "final_loglik_rel_diff": abs(ll4 - ll1) / abs(ll1),
             "one_device_s": s1, "mesh_s": s4}
        res[kernel] = r
        print(f"phase C {kernel}: {json.dumps(r)}", flush=True)
    os.remove(counts)  # ~100 MB at config #5; the outputs stay
    res["peak_bytes_in_use"] = peak_bytes()
    for kernel in kernels:
        r = res[kernel]
        _gate(r["tau_star_agreement"] >= 0.99,
              f"{kernel} mesh vs one-device tau_star agreement "
              f"{r['tau_star_agreement']} >= 0.99")
        _gate(r["final_loglik_rel_diff"] <= 1e-4,
              f"{kernel} mesh vs one-device final loglik rel diff "
              f"{r['final_loglik_rel_diff']} <= 1e-4")
    return res


# --------------------------------------------------------------------------
# --tune: kernel launch-shape sweep (tau sweep + swap, one jitted call)
# --------------------------------------------------------------------------

def tune(shapes=SHAPES, rows=(8, 16, 32), warps=(2, 4, 8),
         chunks=(16, 32, 64), reps=10) -> list:
    import jax
    import jax.numpy as jnp

    from desman_tpu import synth
    from desman_tpu.likelihood import mixture
    from desman_tpu.ops.tau_pallas import tau_sweep_pallas
    from desman_tpu.utils import one_hot_tau

    def sweep_prog(bv, w, sc):
        return jax.jit(lambda n, tau, mix, gamma, eta, k, ks: tau_sweep_pallas(
            n, tau, mix, gamma, eta, k, swap_key=ks, block_rows=bv,
            num_warps=w, s_chunk=sc))

    table = []
    for V, S, G in shapes:
        t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=0)
        n = jnp.asarray(t.data.counts, jnp.float32)
        tau0 = jnp.asarray(np.random.default_rng(0).integers(0, 4, (V, G)),
                           jnp.int32)
        gamma = jnp.asarray(t.gamma, jnp.float32)
        eta = jnp.asarray(t.eta, jnp.float32)
        mix0 = mixture(one_hot_tau(tau0), gamma)
        key = jax.random.PRNGKey(1)
        args = (n, tau0, mix0, gamma, eta, key, jax.random.fold_in(key, 7))
        for bv in rows:
            for w in warps:
                for sc in [c for c in chunks if c < 2 * S]:
                    try:
                        c, cs = _timed_compile(sweep_prog(bv, w, sc), *args)
                        _block(c(*args))
                        ts = []
                        for _ in range(reps):
                            t0 = time.perf_counter()
                            _block(c(*args))
                            ts.append(time.perf_counter() - t0)
                        row = {"shape": [V, S, G], "block_rows": bv,
                               "num_warps": w, "s_chunk": sc,
                               "compile_s": cs,
                               "ms": float(np.median(ts)) * 1e3}
                    except Exception as e:  # a shape the compiler refuses
                        row = {"shape": [V, S, G], "block_rows": bv,
                               "num_warps": w, "s_chunk": sc,
                               "error": f"{type(e).__name__}: {e}"[:300]}
                    table.append(row)
                    print(f"tune: {json.dumps(row)}", flush=True)
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only phase C (--mesh 1x4 vs one GPU)")
    ap.add_argument("--tune", action="store_true",
                    help="run only the tau-kernel launch-shape sweep")
    ap.add_argument("--seed", type=int, default=0,
                    help="data seed (phase A offsets the mock's own 2017)")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found platform "
              f"{dev.platform!r}", file=sys.stderr)
        return 1
    want = 4 if args.four else 1
    if len(jax.devices()) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 1

    from desman_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    for line in card_lines():
        print(f"card: {line}", flush=True)
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"jax {jax.__version__}", flush=True)
    os.makedirs(OUT, exist_ok=True)

    results = {}
    if args.tune:
        results["tune"] = tune()
        if any("error" in row for row in results["tune"]):
            print("chip_smoke: some launch shapes failed to compile",
                  file=sys.stderr)
            return 1
    elif args.four:
        results["C"] = phase_c(os.path.join(OUT, "phase_c"), seed=args.seed)
    else:
        results["A"] = phase_a(os.path.join(OUT, "phase_a"),
                               seed=2017 + args.seed)
        results["B"] = [phase_b(V, S, G, seed=args.seed)
                        for V, S, G in SHAPES]
    with open(os.path.join(OUT, "results.json"), "w") as f:
        json.dump(results, f, indent=1, default=str)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
