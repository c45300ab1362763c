"""Pallas tau-sweep kernel (Triton route) against the XLA path.

The CPU tests run the kernel in the Pallas interpreter (``interpret=True``
passed explicitly); the compiled kernel needs a GPU, where the `gpu`-marked
tests and ``python chip_smoke.py`` exercise it. Both paths draw identical
Gumbel noise (same fold_in scheme), so disagreements can only come from
float summation order at near-ties.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from desman_tpu import synth
from desman_tpu.likelihood import mixture
from desman_tpu.ops import tau_pallas
from desman_tpu.ops.tau_pallas import tau_sweep_pallas
from desman_tpu.sampler import tau_swap_move, tau_sweep_xla
from desman_tpu.utils import one_hot_tau

kernel = functools.partial(tau_sweep_pallas, interpret=True)


def _setup(V=96, S=12, G=3, seed=0):
    t = synth.generate(V=V, S=S, G=G, coverage=50.0, seed=seed)
    n = jnp.asarray(t.data.counts, jnp.float32)
    rng = np.random.default_rng(seed)
    tau = jnp.asarray(rng.integers(0, 4, size=(V, G)), jnp.int32)
    gamma = jnp.asarray(t.gamma, jnp.float32)
    eta = jnp.asarray(t.eta, jnp.float32)
    mix = mixture(one_hot_tau(tau), gamma)
    return n, tau, mix, gamma, eta


@pytest.mark.parametrize("V,S,G", [
    (96, 12, 3),     # aligned rows, one masked 16-lane sample chunk
    (77, 40, 5),     # ragged V, S and G not powers of two, tail chunk
    (40, 96, 6),     # S=96: three full 32-lane chunks (config #5's S)
    (33, 6, 1),      # G=1
])
def test_matches_xla_single_sweep(V, S, G):
    n, tau, mix, gamma, eta = _setup(V, S, G)
    key = jax.random.PRNGKey(3)
    tau_x, mix_x = tau_sweep_xla(n, tau, mix, gamma, eta, key)
    tau_p, mix_p = kernel(n, tau, mix, gamma, eta, key, block_rows=16)
    agree = (np.asarray(tau_x) == np.asarray(tau_p)).mean()
    assert agree > 0.99, f"tau agreement {agree}"
    np.testing.assert_allclose(np.asarray(mix_p), np.asarray(mix_x),
                               rtol=1e-5, atol=1e-6)


def test_mix_consistency():
    """Kernel's returned mix must equal the mixture implied by its tau."""
    n, tau, mix, gamma, eta = _setup(V=64, S=8, G=4, seed=1)
    tau_p, mix_p = kernel(n, tau, mix, gamma, eta, jax.random.PRNGKey(0))
    want = mixture(one_hot_tau(tau_p), gamma)
    np.testing.assert_allclose(np.asarray(mix_p), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_padding_path():
    """V not a multiple of the block: masked rows must not perturb results."""
    n, tau, mix, gamma, eta = _setup(V=77, S=6, G=2, seed=2)
    key = jax.random.PRNGKey(1)
    tau_x, _ = tau_sweep_xla(n, tau, mix, gamma, eta, key)
    tau_p, _ = kernel(n, tau, mix, gamma, eta, key, block_rows=32)
    agree = (np.asarray(tau_x) == np.asarray(tau_p)).mean()
    assert agree > 0.99, f"tau agreement {agree}"


def test_padding_is_inert():
    """Zero-count rows and samples (zero gamma), appended explicitly, leave
    every real row's draws unchanged — the kernel's own masks rely on the
    same likelihood-neutrality. Launch shapes that mask differently (block
    rows, sample chunk) give the same draws."""
    n, tau, mix, gamma, eta = _setup(V=45, S=6, G=3, seed=5)
    key = jax.random.PRNGKey(4)
    ref_t, ref_m = kernel(n, tau, mix, gamma, eta, key, block_rows=8,
                          s_chunk=8)
    # two zero-count samples with zero abundance
    n2 = jnp.pad(n, ((0, 0), (0, 2), (0, 0)))
    g2 = jnp.pad(gamma, ((0, 2), (0, 0)))
    m2 = jnp.pad(mix, ((0, 0), (0, 2), (0, 0)))
    t2, mm2 = kernel(n2, tau, m2, g2, eta, key, block_rows=16, s_chunk=4)
    np.testing.assert_array_equal(np.asarray(t2), np.asarray(ref_t))
    np.testing.assert_allclose(np.asarray(mm2)[:, :6], np.asarray(ref_m),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(mm2)[:, 6:], 0.0)
    # strains: G=3 runs inside a 4-column block; rows: tau of a 3-row tail
    t3, _ = kernel(n[:43], tau[:43], mix[:43], gamma, eta, key,
                   block_rows=16)
    np.testing.assert_array_equal(np.asarray(t3), np.asarray(ref_t)[:43])


def test_full_chain_with_pallas_sweep():
    """run_chain with the Pallas sweep recovers truth like the XLA path."""
    from desman_tpu import utils
    from desman_tpu.sampler import SamplerConfig, run_chain

    t = synth.generate(V=96, S=10, G=2, coverage=60.0, seed=5)
    n = jnp.asarray(t.data.counts, jnp.float32)
    cfg = SamplerConfig(G=2, burn=30, samples=30, nmf_iters=100)
    res = run_chain(n, cfg, jax.random.PRNGKey(0),
                    eta_init=jnp.asarray(t.eta, jnp.float32), tau_sweep=kernel)
    dist = utils.snp_distance_perm(t.tau_idx, np.asarray(res.tau_star))
    assert dist <= 4, f"SNP distance {dist}"


def test_sharded_pallas_matches_sharded_xla():
    """shard_mapped Pallas kernel == XLA path on a position-sharded mesh."""
    from desman_tpu.parallel import (
        make_mesh, make_pallas_sweep_sharded, run_chains_sharded,
    )
    from desman_tpu.sampler import SamplerConfig

    t = synth.generate(V=96, S=8, G=2, coverage=50.0, seed=9)
    cfg = SamplerConfig(G=2, burn=4, samples=4, nmf_iters=30)
    mesh = make_mesh(n_chain=1, n_data=4, devices=jax.devices()[:4])

    ref = run_chains_sharded(t.data.counts, cfg, [0], mesh=mesh)
    sweep = make_pallas_sweep_sharded(mesh, interpret=True)
    got = run_chains_sharded(t.data.counts, cfg, [0], mesh=mesh,
                             tau_sweep=sweep)
    agree = (np.asarray(ref.tau_star) == np.asarray(got.tau_star)).mean()
    assert agree > 0.99, f"tau agreement {agree}"
    np.testing.assert_allclose(np.asarray(ref.loglik_trace),
                               np.asarray(got.loglik_trace), rtol=1e-4)


def test_pallas_cli_mesh(tmp_path, capsys):
    """--kernel pallas --mesh: the CLI refuses it off a GPU, naming the
    backend; the same run through run.run_multi with an interpreted kernel
    gets the shard_map wrapper from run.bind_kernel (a raw pallas_call
    cannot be GSPMD-partitioned) and writes its outputs."""
    import os

    from desman_tpu import io
    from desman_tpu.cli import main
    from desman_tpu.parallel import make_mesh
    from desman_tpu.run import RunConfig, run_multi

    t = synth.generate(V=64, S=8, G=2, coverage=50.0, seed=3)
    csv = str(tmp_path / "c.csv")
    io.write_counts_csv(csv, t.data)
    rc = main(["desman", csv, "-g", "2", "-o", str(tmp_path / "cli"), "-i",
               "16", "--chains", "2", "--kernel", "pallas", "--mesh", "2x4"])
    assert rc == 2 and "'cpu'" in capsys.readouterr().err
    out = str(tmp_path / "out")
    run_multi(io.read_counts_csv(csv), RunConfig(G=2, iterations=16,
                                                 out_dir=out),
              n_chains=2, tau_sweep=kernel, mesh=make_mesh(2, 4))
    assert os.path.exists(os.path.join(out, "fit.txt"))


@pytest.mark.parametrize("V", [203, 64])
def test_fused_swap_matches_xla_swap(V):
    """tau_sweep_pallas(swap_key=...) == pallas sweep + tau_swap_move.

    Same proposal stream (draw_swap_proposal); only the MH log-ratio's
    reduction order differs, so decisions agree except at knife-edge
    proposals. V=203 leaves masked rows in the last block (they must never
    accept); V=64 fills every block."""
    n, tau, mix, gamma, eta = _setup(V=V, S=12, G=5, seed=4)
    for i in range(4):
        k = jax.random.PRNGKey(400 + i)
        ks = jax.random.fold_in(k, 12345)
        ta, ma = kernel(n, tau, mix, gamma, eta, k)
        ta, ma = tau_swap_move(n, ta, ma, gamma, eta, ks, beta=0.8)
        tb, mb = kernel(n, tau, mix, gamma, eta, k, swap_key=ks,
                        swap_beta=0.8)
        agree = (np.asarray(ta) == np.asarray(tb)).mean()
        # the design allows knife-edge accept divergence from differing
        # float reduction orders — exact equality would be a latent flake
        assert agree >= 0.999, f"key {i}: tau agreement {agree}"
        if agree == 1.0:
            np.testing.assert_allclose(np.asarray(mb), np.asarray(ma),
                                       rtol=1e-5, atol=1e-6)


def test_fused_swap_used_by_sweep_fn():
    """make_sweep_fn routes through the fused epilogue for the pallas
    kernel (handles_swap) and produces the same chain as the explicit
    unfused composition."""
    from desman_tpu.sampler import (
        SamplerConfig, init_accum, init_state, make_sweep_fn,
    )

    n, tau, mix, gamma, eta = _setup(V=96, S=8, G=4, seed=6)
    cfg = SamplerConfig(G=4, burn=2, samples=4, nmf_iters=20)
    sweep = make_sweep_fn(cfg, tau_sweep=kernel)
    state = init_state(n, cfg, jax.random.PRNGKey(9))
    accum = init_accum(96, 8, 4)
    st, ac = state, accum
    for it in range(6):
        st, ac, ll = sweep(n, st, ac, jnp.int32(it))
    assert np.isfinite(float(ll))
    # unfused reference composition for one sweep from the same state
    k = jax.random.fold_in(state.key, 0)
    k_tau, _, _ = jax.random.split(k, 3)
    t_ref, m_ref = kernel(n, state.tau, state.mix, state.gamma, state.eta,
                          k_tau, temp=jnp.float32(3.0))
    t_ref, m_ref = tau_swap_move(n, t_ref, m_ref, state.gamma, state.eta,
                                 jax.random.fold_in(k_tau, 12345))
    st1, _, _ = sweep(n, state, accum, jnp.int32(0))
    assert (np.asarray(st1.tau) == np.asarray(t_ref)).all()


def test_swap_proposal_never_accepts_for_one_strain():
    n, tau, mix, gamma, eta = _setup(V=20, S=4, G=1, seed=7)
    key = jax.random.PRNGKey(2)
    g, h, logu = tau_pallas.draw_swap_proposal(key, 20, 1)
    assert int(g) == int(h) == 0 and np.isinf(np.asarray(logu)).all()
    ta, ma = kernel(n, tau, mix, gamma, eta, key)
    tb, mb = kernel(n, tau, mix, gamma, eta, key, swap_key=key)
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
    np.testing.assert_array_equal(np.asarray(ma), np.asarray(mb))


def test_compiled_kernel_refuses_cpu():
    """interpret=False off a GPU raises, naming the backend — no silent
    fallback to the interpreter."""
    n, tau, mix, gamma, eta = _setup(V=16, S=4, G=2)
    with pytest.raises(ValueError, match="'cpu'"):
        tau_sweep_pallas(n, tau, mix, gamma, eta, jax.random.PRNGKey(0))
    from desman_tpu.parallel import make_mesh, make_pallas_sweep_sharded

    with pytest.raises(ValueError, match="'cpu'"):
        make_pallas_sweep_sharded(make_mesh(1, 4))


def test_cli_kernel_pallas_refuses_cpu(tmp_path, capsys):
    from desman_tpu import io
    from desman_tpu.cli import main

    t = synth.generate(V=20, S=4, G=2, seed=0)
    csv = str(tmp_path / "c.csv")
    io.write_counts_csv(csv, t.data)
    rc = main(["desman", csv, "-g", "2", "-o", str(tmp_path / "o"),
               "-i", "4", "--kernel", "pallas"])
    err = capsys.readouterr().err
    assert rc == 2 and "GPU" in err and "'cpu'" in err
    assert not (tmp_path / "o").exists()


def test_resolve_tau_sweep_names():
    from desman_tpu.ops import resolve_tau_sweep

    assert resolve_tau_sweep("xla") is None
    assert resolve_tau_sweep(None) is None
    assert resolve_tau_sweep("pallas") is tau_sweep_pallas
    for gone in ("pallas_topk", "pallas_resident"):
        with pytest.raises(ValueError, match="unknown tau kernel"):
            resolve_tau_sweep(gone)


@pytest.mark.parametrize("V,S,G", [(10_000, 64, 8), (100_000, 96, 16),
                                   (7_000, 64, 5)])
def test_kernel_lowers_for_cuda(V, S, G, monkeypatch):
    """The kernel lowers through Pallas' Triton route for CUDA at the
    widths chip_smoke runs (block shapes powers of two, no unsupported
    op) — checked here without a GPU by cross-platform lowering."""
    monkeypatch.setattr(tau_pallas, "require_gpu", lambda interpret: None)
    f32 = jnp.float32

    def sweep(n, tau, mix, gamma, eta, gz, logu):
        return tau_pallas.tau_sweep_pallas_from_gz(
            n, tau, mix, gamma, eta, gz,
            swap_proposal=(jnp.int32(0), jnp.int32(1), logu))

    args = (jax.ShapeDtypeStruct((V, S, 4), f32),
            jax.ShapeDtypeStruct((V, G), jnp.int32),
            jax.ShapeDtypeStruct((V, S, 4), f32),
            jax.ShapeDtypeStruct((S, G), f32),
            jax.ShapeDtypeStruct((4, 4), f32),
            jax.ShapeDtypeStruct((V, 4 * G), f32),
            jax.ShapeDtypeStruct((V,), f32))
    text = jax.jit(sweep).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text and "tau_sweep" in text


def test_default_launch_shapes():
    for S in (6, 12, 64, 96, 128):
        rows, warps, chunk = tau_pallas.default_launch(S)
        for x in (rows, warps, chunk):
            assert x & (x - 1) == 0
        assert chunk <= 32 and chunk >= min(S, 32) // 2


@pytest.mark.gpu
def test_kernel_on_gpu_matches_xla(gpu):
    """Compiled kernel vs XLA reference at both chip_smoke phase-B shapes."""
    import chip_smoke

    for V, S, G in chip_smoke.SHAPES:
        chip_smoke.phase_b(V, S, G, sweeps=20, chain_sweeps=60, reps=1)
