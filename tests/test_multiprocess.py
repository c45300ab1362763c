"""True multi-process jax.distributed execution (VERDICT r1 item 1).

Round 1 validated sharding only on a single-process virtual mesh; these
tests spawn REAL separate jax processes (the multi-controller model of a
multi-host GPU job, with gloo standing in for NCCL on CPU) and assert the sharded
sampler produces the same trajectories as the in-process single-controller
run — the mesh-shape/process-layout invariance the design claims
(desman_tpu/parallel/sharded.py docstring).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import desman_tpu.synth as synth
from desman_tpu.sampler import SamplerConfig, run_chains

pytestmark = pytest.mark.slow  # long MCMC / subprocess fault injection (make test-fast skips)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_workers(nproc: int, local_devices: int, extra, tmp_path):
    """Launch nproc workers; return the rank-0 output npz path."""
    out = str(tmp_path / "mp_result.npz")
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # each worker sets its own JAX_PLATFORMS/XLA_FLAGS before importing jax
    procs = []
    for pid in range(nproc):
        logf = open(tmp_path / f"worker_{pid}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, "--pid", str(pid),
             "--nproc", str(nproc), "--port", str(port),
             "--local_devices", str(local_devices), "--out", out] + extra,
            env=env, cwd=REPO, stdout=logf, stderr=subprocess.STDOUT,
        ), logf))
    rcs = []
    for p, logf in procs:
        rcs.append(p.wait(timeout=600))
        logf.close()
    if any(rcs):
        logs = "\n".join(
            (tmp_path / f"worker_{i}.log").read_text()[-2000:]
            for i in range(nproc)
        )
        raise AssertionError(f"worker rcs={rcs}\n{logs}")
    return out


@pytest.fixture(scope="module")
def expected():
    """Single-process (virtual 8-device via conftest) reference trajectories.

    Data/config must match tests/mp_worker.py exactly.
    """
    import jax.numpy as jnp

    truth = synth.generate(V=64, S=6, G=3, coverage=50.0, seed=7)
    cfg = SamplerConfig(G=3, burn=20, samples=20, nmf_iters=50)
    res = run_chains(jnp.asarray(truth.data.counts), cfg, seeds=[0, 1])
    return {k: np.asarray(getattr(res, k)) for k in
            ("tau_star", "tau_mean", "gamma_mean", "gamma_star",
             "eta_mean", "star_loglik", "loglik_trace")}


def _check(out_npz, expected):
    got = np.load(out_npz)
    # tau draws are argmax decisions -> exact across process layouts
    np.testing.assert_array_equal(got["tau_star"], expected["tau_star"])
    # float accumulators: gloo all-reduce order may differ from the
    # single-host XLA reduction, so allow a few ulps
    for k in ("tau_mean", "gamma_mean", "gamma_star", "eta_mean",
              "star_loglik", "loglik_trace"):
        np.testing.assert_allclose(
            got[k], expected[k], rtol=2e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("nproc,local", [(2, 4), (4, 2)])
def test_multiprocess_chains_matches_single_process(
        nproc, local, expected, tmp_path):
    out = _spawn_workers(nproc, local, ["--mode", "chains"], tmp_path)
    _check(out, expected)


def test_multiprocess_sharded_checkpoint_crash_resume(tmp_path):
    """VERDICT r1 item 2, across REAL process boundaries: 2 jax processes
    write per-process shard files (each holding only its addressable
    blocks), 'crash' after one segment, relaunch, and the resumed run must
    match an uninterrupted in-process sharded run with the same segment
    schedule (checkpoint_every=7, hardcoded in mp_worker ckpt mode)."""
    import jax
    import jax.numpy as jnp

    ckpt = tmp_path / "mp_ckpt"
    base = ["--mode", "ckpt", "--n_chain", "1", "--ckpt_dir", str(ckpt)]
    # launch 1: simulated crash after the first 7-sweep segment
    _spawn_workers(2, 4, base + ["--stop_after", "7"], tmp_path)
    manifest = ckpt / "manifest.json"
    assert manifest.is_file(), "crash launch must leave a committed step"
    shard_files = sorted(p.name for p in ckpt.glob("p*_it7.npz"))
    assert shard_files == ["p0_it7.npz", "p1_it7.npz"], shard_files
    # no process wrote the other's rows: each file holds only its half of V
    z0 = np.load(ckpt / "p0_it7.npz")
    tau_keys = [k for k in z0.files if k.startswith("state_tau@")]
    assert sum(z0[k].shape[0] for k in tau_keys) == 32  # V=64 over 2 procs

    # launch 2: resume to completion
    out = _spawn_workers(2, 4, base, tmp_path)

    # uninterrupted in-process reference with the same segmentation
    from desman_tpu.parallel import make_mesh, run_chain_sharded_checkpointed

    truth = synth.generate(V=64, S=6, G=3, coverage=50.0, seed=7)
    cfg = SamplerConfig(G=3, burn=20, samples=20, nmf_iters=50)
    ref = run_chain_sharded_checkpointed(
        truth.data.counts, cfg, jax.random.PRNGKey(0),
        str(tmp_path / "ref_ckpt"), checkpoint_every=7,
        mesh=make_mesh(n_chain=1, n_data=8),
    )
    got = np.load(out)
    np.testing.assert_array_equal(got["tau_star"], np.asarray(ref.tau_star))
    for k in ("tau_mean", "gamma_mean", "gamma_star", "eta_mean",
              "star_loglik", "loglik_trace"):
        np.testing.assert_allclose(
            got[k], np.asarray(getattr(ref, k)), rtol=2e-5, atol=1e-6,
            err_msg=k)


def test_multiprocess_chains_ckpt_with_draws_crash_resume(tmp_path):
    """The r3 chain x position shard checkpoint, across REAL process
    boundaries: 2 jax processes run run_chains_sharded_checkpointed with
    store_samples on a 2x4 mesh, 'crash' after one segment (N-D offset
    shard files + shard-local draw files on the shared dir), relaunch, and
    the resumed result — including the assembled thinned draws — must match
    the uninterrupted in-process run."""
    import jax.numpy as jnp

    from dataclasses import replace

    from desman_tpu.parallel import make_mesh, run_chains_sharded

    ckpt = tmp_path / "mp_cc"
    base = ["--mode", "chains_ckpt", "--n_chain", "2",
            "--ckpt_dir", str(ckpt)]
    # crash at sweep 28: past burn (20), so thinned draws already exist
    _spawn_workers(2, 4, base + ["--stop_after", "28"], tmp_path)
    assert (ckpt / "manifest.json").is_file()
    # the chain axis splits across processes: each file's tau blocks carry
    # 2-D (chain,row) offsets and only that process's blocks
    z0 = np.load(ckpt / "p0_it28.npz")
    tau_keys = [k for k in z0.files if k.startswith("state_tau@")]
    assert tau_keys and all("," in k.rsplit("@", 1)[1] for k in tau_keys)
    draw_files = sorted(p.name for p in ckpt.glob("p*_draws_s*.npz"))
    assert draw_files, "segment draw shards must exist after the crash"

    out = _spawn_workers(2, 4, base, tmp_path)

    truth = synth.generate(V=64, S=6, G=3, coverage=50.0, seed=7)
    cfg = replace(SamplerConfig(G=3, burn=20, samples=20, nmf_iters=50),
                  store_samples=True, store_thin=5)
    ref = run_chains_sharded(truth.data.counts, cfg, [0, 1],
                             mesh=make_mesh(n_chain=2, n_data=4))
    got = np.load(out)
    np.testing.assert_array_equal(got["tau_star"], np.asarray(ref.tau_star))
    np.testing.assert_array_equal(got["tau_samples"],
                                  np.asarray(ref.tau_samples))
    for k in ("tau_mean", "gamma_mean", "eta_mean", "loglik_trace"):
        np.testing.assert_allclose(
            got[k], np.asarray(getattr(ref, k)), rtol=2e-5, atol=1e-6,
            err_msg=k)
