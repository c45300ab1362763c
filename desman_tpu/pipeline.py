"""One-command pipeline: filter -> G-grid -> selection -> (genes) (L4 layer).

The reference drives this stage with shell loops / Snakemake over the CLIs
(SURVEY.md §3.5); here a single YAML (or dict) config runs the whole
in-scope pipeline on-device and writes a results tree:

    outdir/
      tran_df.csv  sel_var.csv  p_df.csv  q_df.csv      (filter)
      run_<G>_<seed>/...                                 (grid runs)
      collated_fits.csv  best.txt                        (selection)
      geneassign_*                                       (optional)

Config keys (all optional except counts):
    counts: counts.csv
    output_dir: desman_pipeline_out
    filter: {min_coverage: 5.0, q_cutoff: 0.05}
    grid: {g_min: 1, g_max: 8, seeds: [0,1,2], iterations: 250, kernel: xla}
    selection: {dev_cutoff: 0.02, unc_cutoff: 0.1}
    genes: {coverage_csv: gene_cov.csv, max_copy: 1}   # optional stage
"""
from __future__ import annotations

import json
import os
import numpy as np


def load_config(path: str) -> dict:
    """YAML if available (L4 parity with the Snakemake config), else JSON."""
    text = open(path).read()
    try:
        import yaml

        return yaml.safe_load(text)
    except ImportError:
        return json.loads(text)


def run_pipeline(config: dict) -> dict:
    """Execute the pipeline; returns a summary dict (also written to disk)."""
    from . import io
    from .filter import FilterConfig, filter_variants
    from .model_selection import fit_grid, resolve_nhap

    counts_path = config["counts"]
    outdir = config.get("output_dir", "desman_pipeline_out")
    os.makedirs(outdir, exist_ok=True)

    data = io.read_counts_csv(counts_path)

    # ---- filter ----
    fcfg = FilterConfig(**config.get("filter", {}))
    fres = filter_variants(data, fcfg)
    sel = data.select(np.flatnonzero(fres.selected))
    io.write_counts_csv(os.path.join(outdir, "sel_var.csv"), sel)
    io.write_eta_csv(os.path.join(outdir, "tran_df.csv"), fres.eta)
    io.write_position_csv(os.path.join(outdir, "p_df.csv"), data.contigs,
                          data.positions, "p", fres.pvalues)
    io.write_position_csv(os.path.join(outdir, "q_df.csv"), data.contigs,
                          data.positions, "q", fres.qvalues)

    # ---- grid ----
    grid = config.get("grid", {})
    g_values = list(range(int(grid.get("g_min", 1)), int(grid.get("g_max", 8)) + 1))
    seeds = list(grid.get("seeds", [0, 1, 2]))
    from .ops import resolve_tau_sweep

    tau_sweep = resolve_tau_sweep(grid.get("kernel"))
    records = fit_grid(
        sel.counts, g_values=g_values, seeds=seeds,
        iterations=int(grid.get("iterations", 250)),
        eta_init=fres.eta, fix_eta=bool(grid.get("fix_eta", True)),
        out_stub=os.path.join(outdir, "run"), data=sel,
        tau_sweep=tau_sweep,
        # ESS-guaranteed deviances for the selection rule (optional)
        ess_target=float(grid.get("auto_samples", 0.0)),
        max_samples=int(grid.get("auto_max_samples", 2000)),
    )
    io.write_records_csv(os.path.join(outdir, "collated_fits.csv"),
                         [r.__dict__ for r in records])

    # ---- selection ----
    scfg = config.get("selection", {})
    selres = resolve_nhap(
        records, dev_cutoff=float(scfg.get("dev_cutoff", 0.02)),
        unc_cutoff=float(scfg.get("unc_cutoff", 0.1)),
    )
    with open(os.path.join(outdir, "best.txt"), "w") as f:
        f.write("G,seed,uncertainty,mean_deviance,run_dir\n")
        f.write(selres.summary_line() + "\n")

    summary = {
        "V_total": int(data.V),
        "V_selected": int(sel.V),
        "selected_G": selres.G,
        "best_seed": selres.seed,
        "uncertainty": selres.uncertainty,
        "mean_deviance": selres.mean_deviance,
        "best_run_dir": selres.run_dir,
    }

    # ---- genes (optional) ----
    genes = config.get("genes")
    if genes:
        import pandas as pd

        from .geneassign import (
            GeneAssignConfig, assign_genes, sample_total_coverage,
            strain_coverage,
        )

        gdf = io.read_gene_cov_csv(genes["coverage_csv"])
        gene_cov = gdf.to_numpy(dtype=np.float64)
        gamma = io.read_gamma_csv(
            os.path.join(selres.run_dir, "Gamma_mean.csv"))
        total = sample_total_coverage(data.counts)
        cov = strain_coverage(gamma, total)
        gres = assign_genes(gene_cov, cov, GeneAssignConfig(
            max_copy=int(genes.get("max_copy", 1)),
            model=genes.get("model", "quasipoisson"),
        ))
        cols = [f"H{g + 1}" for g in range(gamma.shape[1])]
        pd.DataFrame(np.asarray(gres.eta_star), index=gdf.index,
                     columns=cols).to_csv(
            os.path.join(outdir, "geneassign_etaS_df.csv"))
        pd.DataFrame(np.asarray(gres.presence_prob), index=gdf.index,
                     columns=cols).to_csv(
            os.path.join(outdir, "geneassign_etaP_df.csv"))
        summary["genes_assigned"] = int(gene_cov.shape[0])

    with open(os.path.join(outdir, "pipeline_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary
