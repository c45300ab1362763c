"""Command-line entry points (the reference's L3 layer, SURVEY.md §1).

Subcommands mirroring the reference's CLI surface and flag semantics
(SURVEY.md §8: ``bin/desman``'s -g/-e/-o/-i/-s/-r/-m, the filter CLI, the
GeneAssign CLI, resolvenhap) plus the extensions of this implementation:

    extract      mpileup -> counts CSV (+ gene coverage); native C++ scanner
    filter       variant-position LLR filter -> sel_var/p/q/tran_df CSVs
    desman       tau/gamma/eta Gibbs deconvolution (--chains, --pt,
                 --auto_burn, --checkpoint, --kernel pallas, --mesh CxD)
    multibin     deconvolve many genome bins in one device program
    pipeline     filter -> G-grid -> selection (-> genes) from one YAML
    resolvenhap  pick the number of strains from a run grid (-c copies)
    collate      one CSV of a run grid's fit records
    diag         split R-hat / ESS / replicate tau agreement per G
    geneassign   accessory-gene strain assignment (+ --assign_tau)
    genecov      per-gene coverage matrix from a counts CSV
    validate     permutation-matched SNP/gamma error vs ground truth
    strainfasta  strain genome sequences from tau calls

    python -m desman_tpu.cli <command> --help   # per-command flags

Exact reference flag letters are [M] (mount was empty — SURVEY.md §9.5);
semantics follow the published usage. Long options are provided for all.
"""
from __future__ import annotations

import argparse
import glob as globlib
import json
import os
import sys

import numpy as np


def _expand_dirs(patterns) -> list:
    """Glob-expand run-dir patterns, deduplicated, order-preserving."""
    seen = set()
    dirs = []
    for pat in patterns:
        hits = sorted(globlib.glob(pat))
        for d in hits if hits else [pat]:
            key = os.path.normpath(os.path.abspath(d))
            if key not in seen:
                seen.add(key)
                dirs.append(d)
    return dirs


def _resolve_kernel(prog: str, kernel: str):
    """--kernel name -> tau_sweep (None = XLA default); False after printing
    why the kernel cannot run on this backend."""
    from .ops import resolve_tau_sweep
    from .ops.tau_pallas import require_gpu

    tau_sweep = resolve_tau_sweep(kernel)
    if tau_sweep is not None:
        try:
            require_gpu(interpret=False)
        except ValueError as e:
            print(f"{prog}: --kernel {kernel}: {e}", file=sys.stderr)
            return False
    return tau_sweep


def _desman(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman", description="Strain deconvolution (tau/gamma/eta Gibbs sampler)"
    )
    ap.add_argument("variant_file", help="counts CSV: Contig,Position,<sample>-A..T")
    ap.add_argument("-g", "--num_strains", type=int, required=True)
    ap.add_argument("-e", "--eta_file", default=None,
                    help="tran_df.csv from the filter; fixes eta unless --sample_eta")
    ap.add_argument("-o", "--output_dir", default="desman_out")
    ap.add_argument("-i", "--iterations", type=int, default=250)
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("-r", "--random_positions", type=int, default=0,
                    help="subsample this many positions (0 = all)")
    ap.add_argument("-m", "--min_coverage", type=float, default=0.0)
    ap.add_argument("--sample_eta", action="store_true",
                    help="sample eta even when -e seeds it")
    ap.add_argument("-t", "--tau_init", default=None,
                    help="Filtered_Tau_star.csv to initialize tau from")
    ap.add_argument("-f", "--tau_fixed", default=None,
                    help="Filtered_Tau_star.csv to FIX tau to (fits gamma/eta "
                    "only, e.g. assigning new samples to known haplotypes)")
    ap.add_argument("--chains", type=int, default=1,
                    help="vmapped chains (seeds seed..seed+chains-1); best by "
                    "star likelihood is written")
    ap.add_argument("--kappa_gamma", type=float, default=0.0,
                    help="gamma MH proposal concentration (0 = auto: "
                    "warm-start from the data's posterior curvature)")
    ap.add_argument("--kappa_eta", type=float, default=0.0,
                    help="eta MH proposal concentration (0 = auto)")
    ap.add_argument("--checkpoint", default=None,
                    help="npz path: checkpoint every --checkpoint_every "
                    "sweeps and resume from it if present")
    ap.add_argument("--checkpoint_every", type=int, default=50)
    ap.add_argument("--profile", default=None,
                    help="write a jax.profiler device trace to this dir")
    ap.add_argument("--kernel", choices=["xla", "pallas"], default="xla",
                    help="tau-sweep implementation: xla (plain XLA, any "
                    "backend) or pallas (fused Pallas/Triton kernel with "
                    "the swap move as its epilogue; GPU only)")
    ap.add_argument("--pt", type=int, default=0, metavar="R",
                    help="parallel tempering with R replicas (better mixing "
                    "on multimodal posteriors; composes with --chains/"
                    "--mesh/-t/-f/--checkpoint, and with --auto_burn/"
                    "--auto_samples via the cold-rung trace)")
    ap.add_argument("--pt_max_temp", type=float, default=8.0)
    ap.add_argument("--auto_burn", action="store_true",
                    help="extend burn-in until the loglik plateaus (at "
                    "least -i/2, at most --auto_max_burn); -i/2 sampling "
                    "sweeps follow")
    ap.add_argument("--auto_tol", type=float, default=1e-5)
    ap.add_argument("--auto_max_burn", type=int, default=2000)
    ap.add_argument("--auto_samples", type=float, default=0.0, metavar="ESS",
                    help="extend sampling past -i/2 sweeps until the "
                    "post-burn loglik bulk ESS (and min gamma ESS when "
                    "--store_every draws exist) reaches this target, capped "
                    "at --auto_max_samples")
    ap.add_argument("--auto_max_samples", type=int, default=2000)
    ap.add_argument("--mesh", default=None, metavar="CHAINxDATA",
                    help="shard over a device mesh, e.g. 2x4 (chain x "
                    "position axes); requires --chains >= chain axis")
    ap.add_argument("--eta_update", choices=["rows", "joint"], default="joint",
                    help="error-matrix MH: one blocked update (default — 1 "
                    "likelihood pass / 1 collective per sweep) or 4 per-row "
                    "updates (the reference's update shape; same stationary "
                    "distribution)")
    ap.add_argument("--store_every", type=int, default=0, metavar="K",
                    help="write every K-th post-burn (tau,gamma,eta) draw "
                    "to <out>/draws.npz (K must divide the sampling "
                    "sweeps); composes with every run mode "
                    "(--chains/--mesh/--pt/--checkpoint/--auto_burn)")
    args = ap.parse_args(argv)

    from . import io
    from .run import RunConfig, run, run_multi

    data = io.read_counts_csv(args.variant_file)
    rc = RunConfig(
        G=args.num_strains, iterations=args.iterations, seed=args.seed,
        eta_file=args.eta_file, sample_eta=args.sample_eta,
        min_coverage=args.min_coverage, n_positions=args.random_positions,
        out_dir=args.output_dir, kappa_gamma=args.kappa_gamma,
        kappa_eta=args.kappa_eta, checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every, profile_dir=args.profile,
        tau_file=args.tau_fixed or args.tau_init,
        fix_tau=args.tau_fixed is not None,
        pt_replicas=args.pt, pt_max_temp=args.pt_max_temp,
        auto_burn=args.auto_burn, auto_tol=args.auto_tol,
        auto_max_burn=args.auto_max_burn, auto_samples=args.auto_samples,
        auto_max_samples=args.auto_max_samples, eta_update=args.eta_update,
        store_every=args.store_every,
    )
    auto = args.auto_burn or args.auto_samples > 0
    # capability matrix (VERDICT r1 item 4): every mode combination composes
    # (--store_every rides all of them; --pt --mesh --checkpoint and
    # --auto_burn --mesh --checkpoint compose since r4 via the multi-host
    # shard-checkpoint extras channel; --auto_burn --pt composes since r5
    # via the cold-rung plateau trace, converge.run_chain_pt_auto) except
    # the cells below: PT replicas already occupy the mesh chain axis
    # (structural), and auto-length PT runs on one device program without
    # the segment-snapshot machinery (auto+pt+checkpoint/mesh/chains —
    # use a fixed -i for those, or drop one flag).
    if auto and args.pt >= 2 and (args.mesh or args.checkpoint
                                  or args.chains > 1):
        print("desman: --auto_burn/--auto_samples with --pt composes only "
              "single-chain without --mesh/--checkpoint (pin -i for those "
              "combinations)", file=sys.stderr)
        return 2
    if args.mesh and args.pt >= 2 and args.chains > 1:
        print("desman: --pt --mesh does not compose with --chains "
              "(replicas already occupy the mesh chain axis)",
              file=sys.stderr)
        return 2
    tau_sweep = _resolve_kernel("desman", args.kernel)
    if tau_sweep is False:
        return 2
    mesh = None
    if args.mesh:
        from .parallel import make_mesh
        from .parallel.distributed import maybe_initialize

        maybe_initialize()
        c, d = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_mesh(n_chain=c, n_data=d)
        if args.pt >= 2 and args.pt % c != 0:
            print(f"desman: --pt {args.pt} must be a multiple of the mesh "
                  f"chain axis {c}", file=sys.stderr)
            return 2
    if args.checkpoint:
        # SIGTERM (scheduler eviction / preemption) -> finish the
        # in-flight segment, commit its checkpoint, exit 75 (resumable)
        from .checkpoint import Preempted, install_preemption_handler

        install_preemption_handler()
    else:
        Preempted = ()  # nothing raises it without a checkpoint
    try:
        if mesh is not None and args.pt >= 2:
            from .run import run_pt_sharded

            run_pt_sharded(data, rc, mesh, tau_sweep=tau_sweep)
        elif (mesh is not None and args.checkpoint and args.chains <= 1
                and not auto):
            from .run import run_sharded_checkpointed

            run_sharded_checkpointed(data, rc, mesh, tau_sweep=tau_sweep)
        elif args.chains > 1 or mesh is not None:
            run_multi(data, rc, n_chains=max(args.chains, 1),
                      tau_sweep=tau_sweep, mesh=mesh)
        else:
            run(data, rc, tau_sweep=tau_sweep)
    except Preempted as e:
        print(f"desman: preempted — {e}", file=sys.stderr)
        return 75  # EX_TEMPFAIL: rerun the same command to resume
    print(f"desman: wrote {args.output_dir}/fit.txt")
    return 0


def _filter(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-filter", description="Variant-position LLR filter"
    )
    ap.add_argument("counts_file")
    ap.add_argument("-o", "--output_stub", default="filtered_")
    ap.add_argument("-m", "--min_coverage", type=float, default=5.0)
    ap.add_argument("-q", "--q_cutoff", type=float, default=0.05)
    ap.add_argument("-p", "--p_cutoff", type=float, default=0.0,
                    help="select on raw p-values instead of BH q (0 = off)")
    ap.add_argument("-f", "--max_iterations", type=int, default=8,
                    help="outer eta re-estimation rounds")
    ap.add_argument("--chi2_df", type=float, default=0.0,
                    help="LRT degrees of freedom (0 = auto: 1 pooled, "
                    "S with --per_sample)")
    ap.add_argument("--per_sample", action="store_true",
                    help="H1 mixture fraction free per sample: detects "
                    "variants present in few samples that the pooled "
                    "test dilutes")
    args = ap.parse_args(argv)

    from . import io
    from .filter import FilterConfig, filter_variants

    data = io.read_counts_csv(args.counts_file)
    cfg = FilterConfig(
        min_coverage=args.min_coverage, q_cutoff=args.q_cutoff,
        p_cutoff=args.p_cutoff,
        max_outer_iters=args.max_iterations, chi2_df=args.chi2_df,
        per_sample=args.per_sample,
    )
    res = filter_variants(data, cfg)

    stub = args.output_stub
    sel = data.select(np.flatnonzero(res.selected))
    io.write_counts_csv(stub + "sel_var.csv", sel)
    io.write_eta_csv(stub + "tran_df.csv", res.eta)
    io.write_position_csv(stub + "p_df.csv", data.contigs, data.positions,
                          "p", res.pvalues)
    io.write_position_csv(stub + "q_df.csv", data.contigs, data.positions,
                          "q", res.qvalues)
    with open(stub + "log_file.txt", "w") as f:
        f.write(
            f"positions={data.V} selected={int(res.selected.sum())} "
            f"outer_iters={res.n_outer_iters}\n"
        )
    print(
        f"filter: {int(res.selected.sum())}/{data.V} variants -> {stub}sel_var.csv"
    )
    return 0


def _geneassign(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-geneassign", description="Assign accessory genes to strains"
    )
    ap.add_argument("-g", "--gamma_file", required=True, help="Gamma_mean.csv")
    ap.add_argument("-c", "--gene_cov_file", required=True,
                    help="CSV: gene name + per-sample mean coverage columns")
    ap.add_argument("-t", "--total_cov_file", default=None,
                    help="CSV: per-sample total bin coverage (one row per sample); "
                    "default: derived from --core_counts")
    ap.add_argument("--core_counts", default=None,
                    help="core counts CSV to derive per-sample total coverage")
    ap.add_argument("-o", "--output_stub", default="geneassign_")
    ap.add_argument("-m", "--max_copy", type=int, default=1)
    ap.add_argument("--model", choices=["quasipoisson", "gaussian"],
                    default="quasipoisson")
    ap.add_argument("--assign_tau", default=None, metavar="GENE_VAR_COUNTS",
                    help="gene variant-counts CSV: also assign gene-level "
                    "SNVs to strains with gamma/eta frozen (reference "
                    "--assign_tau mode); requires -e")
    ap.add_argument("-e", "--eta_file", default=None,
                    help="tran_df.csv / Eta_star.csv for --assign_tau")
    args = ap.parse_args(argv)

    import pandas as pd

    from . import io
    from .geneassign import (
        GeneAssignConfig, assign_gene_tau, assign_genes,
        sample_total_coverage, strain_coverage,
    )

    gamma = io.read_gamma_csv(args.gamma_file)          # [S,G]
    gdf = io.read_gene_cov_csv(args.gene_cov_file)      # [D,S]
    gene_cov = gdf.to_numpy(dtype=np.float64)
    if args.total_cov_file:
        total = pd.read_csv(args.total_cov_file, index_col=0).to_numpy().ravel()
    elif args.core_counts:
        total = sample_total_coverage(io.read_counts_csv(args.core_counts).counts)
    else:
        # fall back: total coverage ~ mean gene coverage per sample. Wrong
        # scale whenever the accessory genes are a biased sample of the bin
        # (VERDICT r1 weak #5) — tell the user what is being assumed.
        total = gene_cov.mean(axis=0)
        print(
            "geneassign: WARNING: no -t/--total_cov_file or --core_counts "
            "given; approximating per-sample total bin coverage by the mean "
            "accessory-gene coverage. Strain absolute coverages are biased "
            "if accessory genes are not a representative sample of the bin; "
            "pass --core_counts (the filtered core counts CSV) for the "
            "reference-faithful derivation.", file=sys.stderr,
        )
    cov = strain_coverage(gamma, total)                 # [G,S]

    res = assign_genes(gene_cov, cov, GeneAssignConfig(
        max_copy=args.max_copy, model=args.model,
    ))
    stub = args.output_stub
    G = gamma.shape[1]
    cols = [f"H{g + 1}" for g in range(G)]
    pd.DataFrame(np.asarray(res.eta_star), index=gdf.index, columns=cols).to_csv(
        stub + "etaS_df.csv"
    )
    pd.DataFrame(np.asarray(res.presence_prob), index=gdf.index, columns=cols).to_csv(
        stub + "etaP_df.csv"
    )
    pd.DataFrame(
        {"loglik": np.asarray(res.loglik), "confidence": np.asarray(res.confidence)},
        index=gdf.index,
    ).to_csv(stub + "eta_conf.csv")
    print(f"geneassign: {gene_cov.shape[0]} genes x {G} strains -> {stub}etaS_df.csv")

    if args.assign_tau:
        if not args.eta_file:
            print("geneassign: --assign_tau requires -e/--eta_file",
                  file=sys.stderr)
            return 2
        var = io.read_counts_csv(args.assign_tau)
        eta = io.read_eta_csv(args.eta_file)
        tau_star, tau_mean = assign_gene_tau(var.counts, gamma, eta)
        io.write_tau_star_csv(stub + "gene_tau_star.csv",
                              np.asarray(tau_star), var.contigs, var.positions)
        io.write_tau_mean_csv(stub + "gene_tau_mean.csv",
                              np.asarray(tau_mean), var.contigs, var.positions)
        print(f"geneassign: assigned tau at {var.V} gene positions -> "
              f"{stub}gene_tau_star.csv")
    return 0


def _resolvenhap(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-resolvenhap",
        description="Pick the number of strains from a grid of run dirs",
    )
    ap.add_argument("run_dirs", nargs="+",
                    help="run output dirs (globs ok), e.g. out_stub_*")
    ap.add_argument("-d", "--dev_cutoff", type=float, default=0.02,
                    help="relative deviance-improvement elbow cutoff")
    ap.add_argument("-u", "--unc_cutoff", type=float, default=0.1)
    ap.add_argument("-o", "--output_file", default=None)
    ap.add_argument("-c", "--copy_dir", default=None,
                    help="copy the chosen run's haplotype/abundance outputs "
                    "here (the reference emits the chosen haplotypes, "
                    "SURVEY.md §3.4)")
    args = ap.parse_args(argv)

    from .model_selection import resolve_nhap, scan_run_dirs

    dirs = [d for d in _expand_dirs(args.run_dirs)
            if os.path.isfile(os.path.join(d, "fit.txt"))]
    if not dirs:
        print("resolvenhap: no run dirs with fit.txt", file=sys.stderr)
        return 1
    records = scan_run_dirs(dirs)
    sel = resolve_nhap(records, dev_cutoff=args.dev_cutoff,
                       unc_cutoff=args.unc_cutoff)
    line = sel.summary_line()
    print("G,seed,uncertainty,mean_deviance,run_dir")
    print(line)
    if args.output_file:
        with open(args.output_file, "w") as f:
            f.write("G,seed,uncertainty,mean_deviance,run_dir\n" + line + "\n")
    if args.copy_dir and sel.run_dir:
        import shutil

        os.makedirs(args.copy_dir, exist_ok=True)
        copied = 0
        for name in ("Filtered_Tau_star.csv", "Tau_mean.csv", "Gamma_mean.csv",
                     "Gamma_star.csv", "Eta_mean.csv", "Eta_star.csv",
                     "fit.txt"):
            src = os.path.join(sel.run_dir, name)
            if os.path.isfile(src):
                shutil.copy2(src, os.path.join(args.copy_dir, name))
                copied += 1
        print(f"resolvenhap: copied {copied} files from {sel.run_dir} "
              f"-> {args.copy_dir}")
    return 0


def _validate(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-validate",
        description="Permutation-matched SNP error vs ground truth "
        "(validateSNP/taucomp equivalent)",
    )
    ap.add_argument("-p", "--pred_tau", required=True,
                    help="predicted Filtered_Tau_star.csv")
    ap.add_argument("-t", "--true_tau", required=True,
                    help="ground-truth tau CSV (same format)")
    ap.add_argument("--pred_gamma", default=None)
    ap.add_argument("--true_gamma", default=None)
    args = ap.parse_args(argv)

    from .validation import validate_files

    rep = validate_files(args.pred_tau, args.true_tau,
                         args.pred_gamma, args.true_gamma)
    hdr = "positions,pred_strains,snp_errors,error_rate"
    if rep.gamma_mae is not None:
        hdr += ",gamma_mae"
    print(hdr)
    print(rep.summary_line())
    return 0


def _genecov(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-genecov",
        description="Per-gene mean coverage matrix from a counts CSV "
        "(ExtractCountFreqGenes equivalent)",
    )
    ap.add_argument("counts_file")
    ap.add_argument("-G", "--genes", required=True,
                    help="gene table: gene,contig,start,end (csv/tsv/bed)")
    ap.add_argument("-o", "--output", default="gene_cov.csv")
    args = ap.parse_args(argv)

    from . import io
    from .genecov import gene_coverage, read_gene_table

    data = io.read_counts_csv(args.counts_file)
    df = gene_coverage(data, read_gene_table(args.genes))
    df.to_csv(args.output)
    print(f"genecov: {len(df)} genes x {data.S} samples -> {args.output}")
    return 0


def _extract(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-extract",
        description="Extract per-position base counts (and per-gene coverage) "
        "from a multi-sample samtools-mpileup file "
        "(ExtractCountFreqGenes equivalent; native C++ scanner)",
    )
    ap.add_argument("pileup_file", help="multi-sample `samtools mpileup` output")
    ap.add_argument("-n", "--sample_names", default=None,
                    help="file with one sample name per line (default: "
                    "Sample1..S)")
    ap.add_argument("-o", "--output", default="counts.csv")
    ap.add_argument("-q", "--min_baseq", type=int, default=0,
                    help="drop bases below this phred quality")
    ap.add_argument("-G", "--genes", default=None,
                    help="gene table (gene,contig,start,end): restrict "
                    "positions to gene regions")
    ap.add_argument("--gene_cov", default=None, metavar="CSV",
                    help="also write the per-gene mean-coverage matrix "
                    "(GeneAssign input); requires -G")
    ap.add_argument("--python", action="store_true",
                    help="force the pure-Python parser")
    args = ap.parse_args(argv)

    if args.gene_cov and not args.genes:
        print("extract: --gene_cov requires -G/--genes", file=sys.stderr)
        return 2

    from . import io
    from .pileup import read_pileup, read_sample_names

    samples = read_sample_names(args.sample_names) if args.sample_names else None
    data = read_pileup(args.pileup_file, samples=samples,
                       min_baseq=args.min_baseq,
                       prefer_native=not args.python)
    if args.genes:
        from .genecov import gene_coverage, read_gene_table
        from .pileup import restrict_to_genes

        genes = read_gene_table(args.genes)
        if args.gene_cov:
            gene_coverage(data, genes).to_csv(args.gene_cov)
            print(f"extract: {len(genes.names)} genes -> {args.gene_cov}")
        data, _ = restrict_to_genes(data, genes)
    io.write_counts_csv(args.output, data)
    print(f"extract: {data.V} positions x {data.S} samples -> {args.output}")
    return 0


def _multibin(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-multibin",
        description="Deconvolve MANY genome bins in one device program "
        "(bins share the sample set; the reference's per-bin shell loop, "
        "batched on the bin axis)",
    )
    ap.add_argument("counts_files", nargs="+",
                    help="one counts CSV per bin (same sample columns)")
    ap.add_argument("-g", "--num_strains", type=int, required=True)
    ap.add_argument("-o", "--output_stub", default="bin_out_",
                    help="per-bin output dir = stub + counts-file basename")
    ap.add_argument("-i", "--iterations", type=int, default=250)
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("-e", "--eta_file", default=None,
                    help="tran_df.csv: fix eta for every bin")
    ap.add_argument("--kernel", choices=["xla", "pallas"], default="xla")
    args = ap.parse_args(argv)

    from . import io
    from .multibin import run_bins_files
    from .sampler import SamplerConfig, tau_sweep_xla

    tau_sweep = _resolve_kernel("desman-multibin", args.kernel)
    if tau_sweep is False:
        return 2
    tau_sweep = tau_sweep or tau_sweep_xla
    eta = io.read_eta_csv(args.eta_file) if args.eta_file else None
    burn = args.iterations // 2
    cfg = SamplerConfig(G=args.num_strains, burn=burn,
                        samples=args.iterations - burn,
                        fix_eta=eta is not None)
    # unique out dir per bin: basename, disambiguated by parent dir then
    # index ('bin1/counts.csv bin2/counts.csv' must not collide)
    from collections import Counter

    stems = [os.path.splitext(os.path.basename(f))[0] for f in args.counts_files]
    stem_count = Counter(stems)
    names = [
        f"{os.path.basename(os.path.dirname(os.path.abspath(f)))}_{stem}"
        if stem_count[stem] > 1 else stem
        for f, stem in zip(args.counts_files, stems)
    ]
    seen: dict = Counter()
    out_dirs = []
    for base in names:
        k = seen[base]
        seen[base] += 1
        out_dirs.append(args.output_stub + (base if k == 0 else f"{base}_{k}"))
    run_bins_files(args.counts_files, cfg, out_dirs, seed=args.seed,
                   eta_init=eta, tau_sweep=tau_sweep)
    print(f"multibin: {len(out_dirs)} bins -> {args.output_stub}*")
    return 0


def _strainfasta(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-strainfasta",
        description="Write strain haplotype sequences from Filtered_Tau_star "
        "calls (the pipeline's final artifact, SURVEY.md §3.5)",
    )
    ap.add_argument("tau_file", help="Filtered_Tau_star.csv")
    ap.add_argument("-f", "--ref_fasta", default=None,
                    help="bin contig FASTA: substitute strain bases into full "
                    "contigs (default: variants-only haplotype strings)")
    ap.add_argument("-o", "--output", default="strains.fasta")
    args = ap.parse_args(argv)

    from .strainfasta import write_strain_fasta

    G = write_strain_fasta(args.tau_file, args.output, ref_fasta=args.ref_fasta)
    print(f"strainfasta: {G} strains -> {args.output}")
    return 0


def _diag(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-diag",
        description="Convergence diagnostics over finished run dirs: "
        "per-G split R-hat / bulk ESS on the post-burn loglik traces and "
        "pairwise replicate tau agreement (taucomp semantics, SURVEY.md §4)",
    )
    ap.add_argument("run_dirs", nargs="+", help="run output dirs (globs ok)")
    ap.add_argument("-b", "--burn_frac", type=float, default=0.5,
                    help="fraction of each trace to discard as burn-in")
    ap.add_argument("-o", "--output", default=None, help="write CSV here")
    args = ap.parse_args(argv)

    from . import io
    from .diagnostics import ess_bulk, replicate_agreement, split_rhat

    # group by (G, V): same strain count AND same position set (different
    # bins/datasets with equal G must not be compared as replicates)
    by_key: dict = {}
    for d in _expand_dirs(args.run_dirs):
        fit_path = os.path.join(d, "fit.txt")
        trace_path = os.path.join(d, "loglik_trace.csv")
        tau_path = os.path.join(d, "Filtered_Tau_star.csv")
        if not (os.path.isfile(fit_path) and os.path.isfile(trace_path)
                and os.path.isfile(tau_path)):
            continue
        G = io.read_fit_txt(fit_path)["G"]
        # each trace drops its OWN burn fraction, then chains align on their
        # LAST n common draws (auto_burn / mixed -i traces differ in length)
        trace = np.loadtxt(trace_path, ndmin=1)
        post = trace[int(len(trace) * args.burn_frac):]
        tau, _, _ = io.read_tau_star_csv(tau_path)
        by_key.setdefault((G, tau.shape[0]), []).append((d, post, tau))
    if not by_key:
        print("diag: no run dirs with fit.txt + loglik_trace.csv + "
              "Filtered_Tau_star.csv", file=sys.stderr)
        return 1
    rows = []
    for (G, V) in sorted(by_key):
        runs = by_key[(G, V)]
        n_draws = min(len(t) for _, t, _ in runs)
        post = np.stack([t[len(t) - n_draws:] for _, t, _ in runs])
        rhat = split_rhat(post) if len(runs) > 1 else float("nan")
        ess = ess_bulk(post)
        agree = replicate_agreement([tau for _, _, tau in runs])
        off = agree[np.triu_indices(len(runs), k=1)]
        rows.append({
            "G": G, "V": V, "chains": len(runs), "split_rhat": rhat,
            "ess_bulk": ess,
            "max_replicate_snp_distance": int(off.max()) if off.size else 0,
        })
        print(f"G={G}: chains={len(runs)} split_rhat={rhat:.4f} "
              f"ess={ess:.1f} max_replicate_snp_dist="
              f"{rows[-1]['max_replicate_snp_distance']}")
        # per-parameter diagnostics from stored posterior draws, when a run
        # was executed with --store_every (loglik can look converged while
        # an individual abundance still drifts)
        from .diagnostics import draws_diagnostics

        per_run = []
        for d, _, _ in runs:
            dpath = os.path.join(d, "draws.npz")
            if os.path.isfile(dpath):
                dd = draws_diagnostics(io.read_draws(dpath))
                per_run.append(dd)
                print(f"  draws[{d}]: n={dd['n_draws']} "
                      f"gamma_ess_min={dd['gamma_ess_min']:.1f} "
                      f"eta_ess_min={dd['eta_ess_min']:.1f}")
        if per_run:
            # aggregate across replicates: worst case (min ESS / min draws)
            # so the CSV row reflects the least-converged run, not the last
            rows[-1].update({
                "draws_runs": len(per_run),
                **{f"draws_{k}": min(dd[k] for dd in per_run)
                   for k in per_run[0]},
            })
    if args.output:
        import pandas as pd

        pd.DataFrame(rows).to_csv(args.output, index=False)
        print(f"diag: wrote {args.output}")
    return 0


def _collate(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-collate",
        description="Collate fit.txt records from run dirs into one CSV "
        "(the reference's deviance-collation scripts, SURVEY.md §2 misc)",
    )
    ap.add_argument("run_dirs", nargs="+")
    ap.add_argument("-o", "--output", default="collated_fits.csv")
    args = ap.parse_args(argv)

    from . import io

    rows = []
    for d in _expand_dirs(args.run_dirs):
        fp = os.path.join(d, "fit.txt")
        if not os.path.isfile(fp):
            continue
        rec = io.read_fit_txt(fp)
        rec["run_dir"] = d
        rows.append(rec)
    if not rows:
        print("collate: no fit.txt found", file=sys.stderr)
        return 1
    import pandas as pd

    pd.DataFrame(rows).sort_values(["G"]).to_csv(args.output, index=False)
    print(f"collate: {len(rows)} runs -> {args.output}")
    return 0


def _pipeline(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="desman-pipeline",
        description="Run filter -> G-grid -> selection (-> genes) from one "
        "YAML/JSON config (the reference's Snakemake stage, SURVEY.md §3.5)",
    )
    ap.add_argument("config", help="YAML/JSON pipeline config")
    args = ap.parse_args(argv)

    from .pipeline import load_config, run_pipeline

    summary = run_pipeline(load_config(args.config))
    print(json.dumps(summary, indent=2))
    return 0


_COMMANDS = {
    "desman": _desman,
    "pipeline": _pipeline,
    "filter": _filter,
    "geneassign": _geneassign,
    "resolvenhap": _resolvenhap,
    "validate": _validate,
    "genecov": _genecov,
    "extract": _extract,
    "multibin": _multibin,
    "strainfasta": _strainfasta,
    "diag": _diag,
    "collate": _collate,
}


def _enable_compilation_cache() -> None:
    """Every (G, V, S, sweeps) shape is a fresh compile, far longer than a
    short run, and model-selection grids touch many — cache them across
    runs."""
    try:
        from .utils import enable_compilation_cache

        enable_compilation_cache()
    except Exception:
        pass


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    _enable_compilation_cache()
    if "--debug" in argv:
        # numerical-safety mode (SURVEY.md §5 'sanitizers' row): trap NaNs at
        # the op that produced them and disable jit-caching surprises
        argv.remove("--debug")
        import jax

        jax.config.update("jax_debug_nans", True)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 1
    cmd = argv[0]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; one of {sorted(_COMMANDS)}", file=sys.stderr)
        return 2
    return _COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
