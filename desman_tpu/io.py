"""DESMAN-format I/O.

Format-compatible readers/writers for the reference's file conventions
(SURVEY.md §8 — the compatibility contract):

- variant counts CSV: ``Contig,Position,<sample>-A,<sample>-C,<sample>-G,<sample>-T``
- ``tran_df.csv``: the 4x4 base-transition error matrix eta, rows/cols A,C,G,T
- run output dir: ``fit.txt``, ``Gamma_mean.csv``, ``Gamma_star.csv``,
  ``Eta_mean.csv``, ``Eta_star.csv``, ``Filtered_Tau_star.csv``, ``Tau_mean.csv``
- filter outputs: ``sel_var.csv``, ``p_df.csv``, ``q_df.csv``, ``tran_df.csv``

The reference mount was empty at build time (SURVEY.md provenance warning), so
exact column headers follow the published DESMAN usage; our own pipeline
(model_selection, validation) consumes these same writers, keeping the stack
self-consistent. ``fit.txt`` schema: one CSV line
``G,V,S,mean_deviance,star_deviance,star_loglik`` (documented here because the
model-selection CLI parses it).
"""
from __future__ import annotations

import contextlib
import csv
import os
import re
from dataclasses import dataclass

import numpy as np

from .utils import BASES, NBASES


@dataclass
class CountsData:
    """Dense variant-count tensor plus its row/column labels.

    counts: int32 [V, S, 4] — reads of each base at position v in sample s.
    contigs/positions: length-V labels; samples: length-S names.
    """

    counts: np.ndarray
    contigs: np.ndarray
    positions: np.ndarray
    samples: list

    @property
    def V(self) -> int:
        return self.counts.shape[0]

    @property
    def S(self) -> int:
        return self.counts.shape[1]

    def coverage(self) -> np.ndarray:
        """Per-position per-sample coverage N[v,s]."""
        return self.counts.sum(axis=2)

    def select(self, idx: np.ndarray) -> "CountsData":
        return CountsData(
            counts=self.counts[idx],
            contigs=self.contigs[idx],
            positions=self.positions[idx],
            samples=self.samples,
        )


@contextlib.contextmanager
def decompressed(path: str):
    """Context manager yielding a plain-text path for `path`.

    Gzipped inputs (.gz) are streamed to a temp file for the native
    byte-level parsers (countsio/pileupio read plain files); plain paths
    pass through untouched. Counts CSVs and pileups are routinely shipped
    gzipped, so every reader accepts both. Parse errors raised inside the
    block are rewritten to name the original .gz path, not the temp file.
    """
    if not str(path).endswith(".gz"):
        yield path
        return
    import gzip
    import shutil
    import tempfile

    tmp = tempfile.NamedTemporaryFile(suffix=".txt", delete=False)
    try:
        with tmp, gzip.open(path, "rb") as src:
            shutil.copyfileobj(src, tmp, length=1 << 20)
        try:
            yield tmp.name
        except ValueError as e:  # parser errors cite the temp path
            raise ValueError(str(e).replace(tmp.name, str(path))) from None
    finally:
        os.unlink(tmp.name)


def _read_rows(path: str):
    """(header, body rows) of a CSV file; blank lines are skipped."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: empty CSV")
    return rows[0], rows[1:]


def _write_rows(path: str, header, columns, matrix=None) -> None:
    """Write CSV columns: ``columns`` is a list of 1-D arrays and ``matrix``
    an optional 2-D array appended column-wise. Values are formatted by
    numpy's ``str`` (shortest round-trip repr of each dtype), the format
    the reference tooling's pandas writer produces."""
    cols = [np.asarray(c).astype(str).tolist() for c in columns]
    body = [list(r) for r in zip(*cols)] if cols else None
    if matrix is not None:
        mat = np.asarray(matrix).astype(str).tolist()
        body = mat if body is None else [a + b for a, b in zip(body, mat)]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(body or [])


def _float_matrix(body, first: int, path: str) -> np.ndarray:
    """Columns ``first:`` of the body rows as a float64 matrix."""
    if not body:
        return np.zeros((0, 0), np.float64)
    try:
        return np.array([r[first:] for r in body]).astype(np.float64)
    except ValueError as e:
        raise ValueError(f"{path}: non-numeric value ({e})") from None


def read_counts_csv(path: str, prefer_native: bool = True) -> CountsData:
    """Read a DESMAN variant-count CSV into a dense [V,S,4] tensor.

    Accepts the reference header convention ``<sample>-A`` (also tolerates
    ``<sample>.A`` / ``<sample>_A``). The first two columns are
    ``Contig,Position`` (any capitalization). Gzipped (.gz) input is
    handled transparently. Uses the C++ reader (desman_tpu.native, ~10x
    faster) when its library is available; format errors fall through to
    the Python reader so messages stay uniform.
    """
    if str(path).endswith(".gz"):
        with decompressed(path) as plain:
            return read_counts_csv(plain, prefer_native=prefer_native)
    if prefer_native:
        try:
            from . import native

            if native.available():
                return native.read_counts_csv_native(path)
        except (ValueError, OSError):
            pass  # fall back to the Python reader (and its error reporting)
    cols, body = _read_rows(path)
    if len(cols) < 2 + NBASES:
        raise ValueError(f"{path}: expected Contig,Position + per-sample base columns")

    sample_names: list = []
    sample_cols: dict = {}
    pat = re.compile(r"^(.*)[-._]([ACGT])$")
    for j, c in enumerate(cols[2:], start=2):
        m = pat.match(str(c))
        if not m:
            raise ValueError(f"{path}: column {c!r} does not look like '<sample>-A/C/G/T'")
        name, base = m.group(1), m.group(2)
        if name not in sample_cols:
            sample_cols[name] = {}
            sample_names.append(name)
        sample_cols[name][base] = j

    V = len(body)
    S = len(sample_names)
    if any(len(r) != len(cols) for r in body):
        raise ValueError(f"{path}: rows must have {len(cols)} fields")
    if V:
        try:
            table = np.array([r[2:] for r in body]).astype(np.int64)
        except ValueError as e:
            raise ValueError(f"{path}: non-integer count ({e})") from None
    else:
        table = np.zeros((0, len(cols) - 2), np.int64)
    counts = np.zeros((V, S, NBASES), dtype=np.int32)
    for s, name in enumerate(sample_names):
        for a, base in enumerate(BASES):
            j = sample_cols[name].get(base)
            if j is None:
                raise ValueError(f"{path}: sample {name!r} missing base column {base}")
            counts[:, s, a] = table[:, j - 2]

    return CountsData(
        counts=counts,
        contigs=np.array([r[0] for r in body]),
        positions=np.array([int(r[1]) for r in body], dtype=np.int64),
        samples=sample_names,
    )


def write_counts_csv(path: str, data: CountsData) -> None:
    """Inverse of read_counts_csv (used by the filter to emit sel_var.csv)."""
    header = ["Contig", "Position"] + [
        f"{name}-{base}" for name in data.samples for base in BASES]
    _write_rows(path, header, [data.contigs, data.positions],
                np.asarray(data.counts).reshape(data.V, -1))


def write_position_csv(path: str, contigs, positions, name: str,
                       values) -> None:
    """Contig,Position,<name> table (the filter's p_df/q_df outputs)."""
    _write_rows(path, ["Contig", "Position", name],
                [contigs, positions, np.asarray(values)])


def write_records_csv(path: str, records) -> None:
    """One row per dict (keys of the first give the columns); None is
    written as an empty field."""
    fields = list(records[0]) if records else []
    _write_rows(path, fields, [
        np.array(["" if r[k] is None else r[k] for r in records], dtype=object)
        for k in fields])


def read_gene_cov_csv(path: str):
    """Gene-coverage matrix [D genes x S samples] (GeneAssign input) as a
    pandas DataFrame — geneassign is an optional stage that needs pandas.

    Drops the ``n_positions`` metadata column genecov/extract prepend —
    it is bookkeeping, not a sample.
    """
    import pandas as pd

    df = pd.read_csv(path, index_col=0)
    return df.drop(columns=["n_positions"], errors="ignore")


def read_eta_csv(path: str) -> np.ndarray:
    """Read a tran_df.csv-style 4x4 eta (row = true base, col = read base)."""
    _, body = _read_rows(path)
    eta = _float_matrix(body, 1, path)
    if eta.shape != (NBASES, NBASES):
        raise ValueError(f"{path}: expected 4x4 matrix, got {eta.shape}")
    return eta


def write_eta_csv(path: str, eta: np.ndarray) -> None:
    _write_rows(path, [""] + list(BASES), [list(BASES)], np.asarray(eta))


def write_gamma_csv(path: str, gamma: np.ndarray, samples=None) -> None:
    """gamma [S,G] → CSV with sample index and H1..HG strain columns."""
    gamma = np.asarray(gamma)
    S, G = gamma.shape
    idx = samples if samples is not None else [f"S{i}" for i in range(S)]
    _write_rows(path, [""] + [f"H{g + 1}" for g in range(G)],
                [np.asarray(idx)], gamma)


def read_gamma_csv(path: str) -> np.ndarray:
    _, body = _read_rows(path)
    return _float_matrix(body, 1, path)


def write_tau_star_csv(
    path: str, tau_idx: np.ndarray, contigs, positions
) -> None:
    """Haplotype calls: Contig,Position + one-hot base columns per strain.

    tau_idx: int [V,G]. Column layout ``H<g>-<base>`` mirrors the reference's
    Filtered_Tau_star.csv one-hot encoding.
    """
    tau_idx = np.asarray(tau_idx)
    V, G = tau_idx.shape
    onehot = np.eye(NBASES, dtype=np.int64)[tau_idx].reshape(V, G * NBASES)
    header = ["Contig", "Position"] + [
        f"H{g + 1}-{base}" for g in range(G) for base in BASES]
    _write_rows(path, header, [np.asarray(contigs), np.asarray(positions)],
                onehot)


def read_tau_star_csv(path: str):
    """Read a Filtered_Tau_star.csv back to ([V,G] int calls, contigs, positions)."""
    header, body = _read_rows(path)
    G = (len(header) - 2) // NBASES
    onehot = _float_matrix(body, 2, path).astype(np.int64).reshape(
        len(body), G, NBASES)
    contigs = np.array([r[0] for r in body])
    positions = np.array([int(r[1]) for r in body], dtype=np.int64)
    return onehot.argmax(axis=2).astype(np.int32), contigs, positions


def write_tau_mean_csv(path: str, tau_mean: np.ndarray, contigs, positions) -> None:
    """Posterior base probabilities [V,G,4] (used for SNV uncertainty)."""
    tau_mean = np.asarray(tau_mean)
    V, G, _ = tau_mean.shape
    header = ["Contig", "Position"] + [
        f"H{g + 1}-{base}" for g in range(G) for base in BASES]
    _write_rows(path, header, [np.asarray(contigs), np.asarray(positions)],
                tau_mean.reshape(V, G * NBASES))


def read_tau_mean_csv(path: str) -> np.ndarray:
    header, body = _read_rows(path)
    G = (len(header) - 2) // NBASES
    return _float_matrix(body, 2, path).reshape(len(body), G, NBASES)


def write_fit_txt(
    path: str, G: int, V: int, S: int,
    mean_deviance: float, star_deviance: float, star_loglik: float,
) -> None:
    with open(path, "w") as f:
        f.write("G,V,S,mean_deviance,star_deviance,star_loglik\n")
        f.write(
            f"{G},{V},{S},{mean_deviance:.6f},{star_deviance:.6f},{star_loglik:.6f}\n"
        )


# Adapter seam for the reference's fit.txt (VERDICT r1 item 3): our schema is
# self-invented ([M] — reference mount empty, SURVEY.md §9.4). If the real
# DESMAN writes different/renamed/headerless columns, fix it HERE in one
# place: map each canonical name to the reference's column name (header
# files) or column index (headerless files). Every consumer (resolvenhap,
# diag, collate, pipeline) parses through read_fit_txt.
FIT_COLUMN_ALIASES = {
    "G": ["G", "H", "NHaplotypes", "nhap"],
    "V": ["V", "N", "NPositions"],
    "S": ["S", "NSamples"],
    "mean_deviance": ["mean_deviance", "Dev", "Deviance", "MeanDeviance"],
    "star_deviance": ["star_deviance", "StarDeviance", "DevStar"],
    "star_loglik": ["star_loglik", "StarLogLik", "LP"],
}
# positional schema used when the first line is numeric (headerless file)
FIT_HEADERLESS_COLUMNS = [
    "G", "V", "S", "mean_deviance", "star_deviance", "star_loglik",
]


def _is_numeric_row(fields) -> bool:
    try:
        [float(x) for x in fields]
        return len(fields) > 0
    except ValueError:
        return False


def read_fit_txt(path: str) -> dict:
    """Parse a fit.txt record; tolerant of header renames and headerless
    files via FIT_COLUMN_ALIASES / FIT_HEADERLESS_COLUMNS (adapter seam).
    Missing optional columns come back as NaN; G/mean_deviance are required
    (model selection cannot proceed without them)."""
    with open(path) as f:
        first = f.readline().strip().split(",")
        second = f.readline().strip().split(",")
    if _is_numeric_row(first):  # headerless: positional schema
        rec = dict(zip(FIT_HEADERLESS_COLUMNS, first))
    else:
        rec = dict(zip(first, second))
    out: dict = {}
    for canon, aliases in FIT_COLUMN_ALIASES.items():
        val = next((rec[a] for a in aliases if a in rec), None)
        if val is None:
            if canon in ("G", "mean_deviance"):
                raise ValueError(
                    f"{path}: no column for {canon!r} (header {list(rec)}); "
                    "extend desman_tpu.io.FIT_COLUMN_ALIASES"
                )
            out[canon] = float("nan")
        else:
            out[canon] = float(val)
    out["G"] = int(out["G"])
    for k in ("V", "S"):
        if out[k] == out[k]:  # not NaN
            out[k] = int(out[k])
    return out


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def write_draws(path: str, tau_samples, gamma_samples, eta_samples,
                burn: int, thin: int) -> None:
    """Compressed posterior draws (desman --store_every N -> draws.npz).

    tau draws are int8 [n_draws, V, G]; gamma [n_draws, S, G]; eta
    [n_draws, 4, 4]. Draws are post-burn, every `thin`-th sweep (the
    reference stores its posterior samples similarly — SURVEY.md §0.1
    'store every sample (or thinned)')."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        tau=np.asarray(tau_samples, np.int8),
        gamma=np.asarray(gamma_samples, np.float32),
        eta=np.asarray(eta_samples, np.float32),
        burn=np.asarray(burn, np.int64),
        thin=np.asarray(thin, np.int64),
    )
    os.replace(tmp, path)


def read_draws(path: str) -> dict:
    """Load a draws.npz written by write_draws."""
    z = np.load(path)
    return {
        "tau": z["tau"], "gamma": z["gamma"], "eta": z["eta"],
        "burn": int(z["burn"]), "thin": int(z["thin"]),
    }
