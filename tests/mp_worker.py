"""Multi-process jax.distributed worker (driven by tests/test_multiprocess.py).

Each worker is one jax process (the multi-controller SPMD model a
multi-host GPU job uses — SURVEY.md §2.2 'Distributed comm backend'): it
initializes
jax.distributed against a localhost coordinator, contributes its
--local_devices virtual CPU devices to the global mesh, and executes the
same program as every other process. Cross-process psums ride gloo (the CPU
stand-in for NVLink/NCCL). Process 0 writes the gathered results to --out.

Modes:
  chains       run_chains_sharded on a (chain, data) mesh
  ckpt         run_chain_sharded_checkpointed in --segments pieces
               (per-process shard files; save+resume across process
               boundaries)
  chains_ckpt  run_chains_sharded_checkpointed with store_samples: the
               chain x position N-D shard checkpoint + shard-local draw
               files, across real process boundaries
"""
import argparse
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--local_devices", type=int, default=4)
    ap.add_argument("--out", required=True, help="result npz (written by rank 0)")
    ap.add_argument("--mode", choices=["chains", "ckpt", "chains_ckpt"],
                    default="chains")
    ap.add_argument("--n_chain", type=int, default=2, help="mesh chain axis")
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--stop_after", type=int, default=0,
                    help="ckpt mode: exit after this many sweeps (0 = run all)")
    args = ap.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.local_devices}"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from desman_tpu.parallel.distributed import is_coordinator, maybe_initialize

    assert maybe_initialize(
        coordinator_address=f"localhost:{args.port}",
        num_processes=args.nproc, process_id=args.pid,
    ), "expected a multi-process run"
    assert jax.process_count() == args.nproc

    import numpy as np

    from desman_tpu import synth
    from desman_tpu.parallel import make_mesh
    from desman_tpu.sampler import SamplerConfig

    # must match test_multiprocess.py's single-process reference run
    data = synth.generate(V=64, S=6, G=3, coverage=50.0, seed=7).data
    cfg = SamplerConfig(G=3, burn=20, samples=20, nmf_iters=50)
    n_total = jax.device_count()
    mesh = make_mesh(n_chain=args.n_chain, n_data=n_total // args.n_chain)

    from jax.sharding import NamedSharding, PartitionSpec as P

    def fetch(x):
        """Materialize a global (possibly non-addressable) array on this host."""
        rep = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(x)
        return np.asarray(rep)

    if args.mode == "chains":
        from desman_tpu.parallel import run_chains_sharded

        res = run_chains_sharded(data.counts, cfg, seeds=[0, 1], mesh=mesh)
    elif args.mode == "chains_ckpt":
        from dataclasses import replace

        from desman_tpu.parallel import run_chains_sharded_checkpointed

        assert args.ckpt_dir, "--ckpt_dir required for mode=chains_ckpt"
        cfg_store = replace(cfg, store_samples=True, store_thin=5)
        res = run_chains_sharded_checkpointed(
            data.counts, cfg_store, [0, 1], args.ckpt_dir,
            checkpoint_every=7, mesh=mesh,
            stop_after=args.stop_after or None,
        )
        if res is None:  # interrupted run: resume happens in a later launch
            jax.distributed.shutdown()
            return 0
    else:
        from desman_tpu.parallel import run_chain_sharded_checkpointed

        assert args.ckpt_dir, "--ckpt_dir required for mode=ckpt"
        res = run_chain_sharded_checkpointed(
            data.counts, cfg, jax.random.PRNGKey(0), args.ckpt_dir,
            checkpoint_every=7, mesh=mesh, stop_after=args.stop_after or None,
        )
        if res is None:  # interrupted run: resume happens in a later launch
            jax.distributed.shutdown()
            return 0

    out = {
        "tau_star": fetch(res.tau_star),
        "tau_mean": fetch(res.tau_mean),
        "gamma_mean": fetch(res.gamma_mean),
        "gamma_star": fetch(res.gamma_star),
        "eta_mean": fetch(res.eta_mean),
        "star_loglik": fetch(res.star_loglik),
        "loglik_trace": fetch(res.loglik_trace),
    }
    if res.tau_samples is not None:  # already host-assembled from shard files
        out["tau_samples"] = np.asarray(res.tau_samples)
    if is_coordinator():
        tmp = args.out + ".tmp.npz"
        np.savez(tmp, **out)
        os.replace(tmp, args.out)
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
