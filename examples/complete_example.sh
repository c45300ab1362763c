#!/usr/bin/env bash
# The complete_example workflow at the CLI level (reference L4, SURVEY.md
# §3.5) — the shell-loop form a DESMAN user knows, against the bundled
# TestData. Starts one stage further upstream than the reference's walkthrough
# by synthesizing an mpileup from the counts and re-extracting it (exercising
# the native count-extraction path).
#
#   ./examples/complete_example.sh [outdir] [--quick]
#
# --quick shrinks the grid/iterations for CI; the full run matches the
# quickstart scale (G=1..6 x 2 seeds, 250 sweeps).
set -euo pipefail
cd "$(dirname "$0")/.."
# JAX's default device (the GPU where there is one; JAX_PLATFORMS=cpu for the
# CPU). The desman runs below are sequential: one JAX process per card.

OUT="${1:-cli_example_out}"
GMAX=6; SEEDS="0 1"; ITERS=250
if [[ "${2:-}" == "--quick" || "${1:-}" == "--quick" ]]; then
  [[ "${1:-}" == "--quick" ]] && OUT=cli_example_out
  # 120+ sweeps: fewer under-converges tau_mean and the SNV-uncertainty
  # guard in resolvenhap then (correctly) refuses the larger G
  GMAX=3; SEEDS="0"; ITERS=120
fi
mkdir -p "$OUT"
D="python -m desman_tpu.cli"

echo "== 0. mapped reads -> counts (native extract) =="
python - "$OUT" <<'EOF'
import sys
from desman_tpu import io
from desman_tpu.pileup import write_pileup
out = sys.argv[1]
data = io.read_counts_csv("TestData/variant_counts.csv")
write_pileup(f"{out}/all.pileup", data)
open(f"{out}/sample_names.txt", "w").write("\n".join(data.samples) + "\n")
EOF
$D extract "$OUT/all.pileup" -n "$OUT/sample_names.txt" -o "$OUT/counts.csv"
cmp <(sort "$OUT/counts.csv") <(sort TestData/variant_counts.csv) \
  && echo "extract round-trip: counts identical"

echo "== 1. variant filter =="
$D filter "$OUT/counts.csv" -o "$OUT/filt_" -m 5 -q 0.05

echo "== 2. deconvolution grid (G x seed) =="
for g in $(seq 1 $GMAX); do for s in $SEEDS; do
  $D desman "$OUT/filt_sel_var.csv" -g "$g" -s "$s" \
      -e "$OUT/filt_tran_df.csv" -o "$OUT/run_${g}_${s}" -i "$ITERS"
done; done

echo "== 3. model selection =="
$D resolvenhap "$OUT"'/run_*' -o "$OUT/best.txt" -c "$OUT/chosen"
cat "$OUT/best.txt"

echo "== 4. strain haplotype sequences =="
$D strainfasta "$OUT/chosen/Filtered_Tau_star.csv" -o "$OUT/strains.fasta"
grep -c '^>' "$OUT/strains.fasta" | xargs echo "strain records:"

echo "== 5. validation vs bundled truth =="
$D validate -p "$OUT/chosen/Filtered_Tau_star.csv" -t TestData/true_tau.csv

echo "== 6. accessory genes (synthetic gene coverage from the truth) =="
python - "$OUT" <<'EOF'
import sys
import numpy as np
import pandas as pd
from desman_tpu import io
out = sys.argv[1]
gamma = io.read_gamma_csv(f"{out}/chosen/Gamma_mean.csv")
rng = np.random.default_rng(0)
total = np.full(gamma.shape[0], 40.0)
cov = (gamma * total[:, None]).T
etaG = rng.integers(0, 2, size=(40, gamma.shape[1]))
etaG[etaG.sum(1) == 0, 0] = 1
x = rng.poisson(etaG @ cov)
samples = list(pd.read_csv(f"{out}/chosen/Gamma_mean.csv", index_col=0).index)
pd.DataFrame(x, index=[f"gene{i}" for i in range(40)], columns=samples) \
  .to_csv(f"{out}/gene_cov.csv")
pd.DataFrame({"cov": total}, index=samples).to_csv(f"{out}/total_cov.csv")
np.save(f"{out}/true_etaG.npy", etaG)
EOF
$D geneassign -g "$OUT/chosen/Gamma_mean.csv" -c "$OUT/gene_cov.csv" \
    -t "$OUT/total_cov.csv" -o "$OUT/ga_"
python - "$OUT" <<'EOF'
import sys
import numpy as np
import pandas as pd
out = sys.argv[1]
calls = pd.read_csv(f"{out}/ga_etaS_df.csv", index_col=0).to_numpy()
true = np.load(f"{out}/true_etaG.npy")
acc = float((calls == true).mean()) if calls.shape == true.shape else 0.0
print(f"gene presence accuracy: {acc:.3f}")
assert acc > 0.8, "gene assignment accuracy below gate"
EOF

echo "complete_example.sh: PASS ($OUT)"
