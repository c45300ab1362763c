"""One-command pipeline + fixed-tau mode + diagnostics."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from desman_tpu import io, synth
from desman_tpu.pipeline import run_pipeline
from desman_tpu.diagnostics import ess_bulk, replicate_agreement, split_rhat


def test_pipeline_end_to_end(tmp_path):
    t = synth.generate(V=150, S=10, G=2, coverage=60.0, seed=21)
    counts = str(tmp_path / "counts.csv")
    io.write_counts_csv(counts, t.data)
    # accessory genes against the true strains
    rng = np.random.default_rng(0)
    total = np.full(t.data.S, 40.0)
    cov = (t.gamma * total[:, None]).T
    etaG = rng.integers(0, 2, size=(25, 2))
    etaG[etaG.sum(1) == 0, 0] = 1
    x = rng.poisson(etaG @ cov)
    gene_csv = str(tmp_path / "gene_cov.csv")
    pd.DataFrame(x, index=[f"g{i}" for i in range(25)],
                 columns=t.data.samples).to_csv(gene_csv)

    config = {
        "counts": counts,
        "output_dir": str(tmp_path / "out"),
        "grid": {"g_min": 1, "g_max": 3, "seeds": [0, 1], "iterations": 60},
        "genes": {"coverage_csv": gene_csv},
    }
    summary = run_pipeline(config)
    assert summary["selected_G"] == 2
    assert summary["genes_assigned"] == 25
    out = config["output_dir"]
    for f in ["tran_df.csv", "sel_var.csv", "collated_fits.csv", "best.txt",
              "pipeline_summary.json", "geneassign_etaS_df.csv"]:
        assert os.path.exists(os.path.join(out, f)), f


def test_fix_tau_mode(tmp_path):
    """Reference -f semantics: freeze tau from file, fit gamma for new data."""
    from desman_tpu.run import RunConfig, run

    t = synth.generate(V=100, S=8, G=3, coverage=60.0, seed=31)
    counts = str(tmp_path / "counts.csv")
    io.write_counts_csv(counts, t.data)
    tau_csv = str(tmp_path / "tau.csv")
    io.write_tau_star_csv(tau_csv, t.tau_idx, t.data.contigs, t.data.positions)

    data = io.read_counts_csv(counts)
    res = run(data, RunConfig(
        G=3, iterations=60, out_dir=str(tmp_path / "out"),
        tau_file=tau_csv, fix_tau=True,
        eta_file=None,
    ))
    # tau must remain exactly the input
    assert np.array_equal(np.asarray(res.tau_star), t.tau_idx)
    # and gamma should be recovered WITHOUT permutation freedom
    mae = np.abs(np.asarray(res.gamma_mean) - t.gamma).mean()
    assert mae < 0.02, f"gamma MAE {mae}"


def test_tau_init_alignment_error(tmp_path):
    from desman_tpu.run import RunConfig, load_tau_init, run

    t = synth.generate(V=20, S=4, G=2, coverage=30.0, seed=1)
    tau_csv = str(tmp_path / "tau.csv")
    io.write_tau_star_csv(tau_csv, t.tau_idx[:10], t.data.contigs[:10],
                          t.data.positions[:10])
    with pytest.raises(ValueError, match="missing position"):
        load_tau_init(tau_csv, t.data)


def test_split_rhat_and_ess():
    rng = np.random.default_rng(0)
    good = rng.normal(size=(4, 400))
    assert abs(split_rhat(good) - 1.0) < 0.05
    assert ess_bulk(good) > 400
    # diverged chains -> large rhat
    bad = good + np.arange(4)[:, None] * 10
    assert split_rhat(bad) > 1.5


def test_replicate_agreement():
    rng = np.random.default_rng(0)
    tau = rng.integers(0, 4, size=(50, 3))
    perm = tau[:, [1, 2, 0]]
    m = replicate_agreement([tau, perm, tau])
    assert m[0, 1] == 0 and m[0, 2] == 0
    assert (m.diagonal() == 0).all()


def test_pipeline_kernel_options(tmp_path):
    """The YAML grid's `kernel` resolves through ops.resolve_tau_sweep and
    run.bind_kernel like the CLI: the xla grid runs end to end, the pallas
    kernel (interpreted here) runs inside fit_grid's AOT-compiled per-G
    programs, and the removed kernel names are refused, not defaulted."""
    import functools

    from desman_tpu.model_selection import fit_grid
    from desman_tpu.ops import resolve_tau_sweep
    from desman_tpu.ops.tau_pallas import tau_sweep_pallas

    t = synth.generate(V=80, S=8, G=2, coverage=60.0, seed=4)
    counts = str(tmp_path / "counts.csv")
    io.write_counts_csv(counts, t.data)
    config = {
        "counts": counts,
        "output_dir": str(tmp_path / "out"),
        "grid": {"g_min": 1, "g_max": 2, "seeds": [0], "iterations": 40,
                 "kernel": "xla"},
    }
    summary = run_pipeline(config)
    assert summary["selected_G"] == 2

    recs = fit_grid(t.data.counts, g_values=[2], seeds=[0, 1], iterations=20,
                    tau_sweep=functools.partial(tau_sweep_pallas,
                                                interpret=True))
    assert len(recs) == 2 and all(np.isfinite(r.mean_deviance) for r in recs)

    for gone in ("pallas_resident", "pallas_topk"):
        with pytest.raises(ValueError, match="unknown tau kernel"):
            run_pipeline({**config, "grid": {**config["grid"],
                                              "kernel": gone}})
