"""Divergence-ladder validation of the capped-default align path.

The host engine's default caps (probe score 100,
refine cap 800, junk 0.55) were tuned on LPA; this sweep measures how
far the capped default drifts from the exact optimum as divergence
rises toward the 70% ANI floor (map_parameters.hpp:126).

For each divergence level d (SNP:indel 9:1), a synthetic pair is
mapped once and aligned TWICE — capped default vs exact mode
(WFMASH_TPU_HOST_SCORE_CAP=0) — and compared row-for-row:

* cigar_diff : fraction of rows whose CIGAR bytes differ
* gi_delta   : mean / max (exact_gi - default_gi) over rows
               (positive = the default lost identity)
* cov_delta  : query-coverage fraction difference (aligned rows)

Usage: python scripts/divergence_ladder.py [--bp 200000] [--seed 7]
Writes a markdown table to stdout (ARCHITECTURE.md fidelity ledger).
The regression bound is pinned by tests/test_divergence_ladder.py.
"""

import argparse
import io
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

ACGT = np.frombuffer(b"ACGT", np.uint8)


def mutate(seq: np.ndarray, div: float, rng) -> np.ndarray:
    """Apply `div` divergence: 90% SNPs, 5% 1-10bp insertions,
    5% 1-10bp deletions (event-weighted)."""
    out = []
    i = 0
    n = len(seq)
    p_ev = div / (0.9 + 0.1 * 5.5)   # events per base (indels avg 5.5bp)
    while i < n:
        if rng.random() < p_ev:
            r = rng.random()
            if r < 0.90:
                out.append((seq[i] + rng.integers(1, 4)) % 4)
                i += 1
            elif r < 0.95:
                out.append(rng.integers(0, 4, size=int(rng.integers(1, 11))))
                # insertion: emit extra bases, keep current base
            else:
                i += int(rng.integers(1, 11))   # deletion
        else:
            out.append(seq[i])
            i += 1
    return np.concatenate([np.atleast_1d(np.asarray(x)) for x in out]) \
        .astype(np.uint8)


def write_pair(path_t, path_q, bp: int, div: float, seed: int):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, bp).astype(np.uint8)
    q = mutate(t, div, rng)
    for path, name, arr in ((path_t, "anc", t), (path_q, "der", q)):
        s = ACGT[arr].tobytes().decode()
        with open(path, "w") as fh:
            fh.write(f">{name}\n")
            for i in range(0, len(s), 60):
                fh.write(s[i:i + 60] + "\n")
        with open(path + ".fai", "w") as fh:
            fh.write(f"{name}\t{len(s)}\t{len(name) + 2}\t60\t61\n")


def run_pair(path_t, path_q, pct_id: float):
    """Map once; align (default, exact). Returns (rows_def, rows_exact)
    keyed by (qname, tname, qstart, tstart-ish)."""
    from wfmash_tpu.align.engine import run_alignment
    from wfmash_tpu.params import AlignParams, MapParams
    from wfmash_tpu.runner import run_mapping

    mp = MapParams(ref_sequences=[path_t], query_sequences=[path_q],
                   percentage_identity=pct_id, auto_pct_identity=False,
                   threads=1).finalize()
    buf = io.StringIO()
    run_mapping(mp, buf)
    map_paf = "/tmp/divladder-map.paf"
    with open(map_paf, "w") as fh:
        fh.write(buf.getvalue())

    def align(exact: bool):
        old = os.environ.get("WFMASH_TPU_HOST_SCORE_CAP")
        if exact:
            os.environ["WFMASH_TPU_HOST_SCORE_CAP"] = "0"
        try:
            ap = AlignParams(ref_sequences=[path_t],
                             query_sequences=[path_q],
                             mashmap_paf_file=map_paf,
                             threads=1).finalize(mp.window_length)
            out = io.StringIO()
            run_alignment(ap, out)
            return out.getvalue()
        finally:
            if exact:
                if old is None:
                    os.environ.pop("WFMASH_TPU_HOST_SCORE_CAP", None)
                else:
                    os.environ["WFMASH_TPU_HOST_SCORE_CAP"] = old

    return align(False), align(True)


def parse_rows(text: str):
    rows = {}
    for line in text.splitlines():
        f = line.split("\t")
        if len(f) < 12:
            continue
        tags = {t.split(":")[0]: t.split(":", 2)[2]
                for t in f[12:] if t.count(":") >= 2}
        if tags.get("pt") == "true":
            continue            # inversion extra rows: not row-matched
        key = (f[0], f[5], int(f[2]), int(f[7]))
        rows[key] = (float(tags.get("gi", 0)), tags.get("cg", ""),
                     int(f[2]), int(f[3]))
    return rows


def coverage(rows, qlen: int) -> float:
    iv = sorted((qs, qe) for (_, _, _, _), (_, _, qs, qe)
                in rows.items())
    cov, end = 0, 0
    for a, b in iv:
        a = max(a, end)
        if b > a:
            cov += b - a
            end = b
    return cov / qlen if qlen else 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bp", type=int, default=200000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--levels", type=str,
                    default="0.01,0.02,0.05,0.08,0.12,0.15,0.25")
    args = ap.parse_args()

    print("| divergence | -p | rows | cigar_diff | mean gi delta "
          "| max gi delta | cov default | cov exact |")
    print("|---|---|---|---|---|---|---|---|")
    for div in [float(x) for x in args.levels.split(",")]:
        # mapping identity floor: stay under the divergence (ANI floor
        # case: -p 70, the reference's default floor)
        pct = max(0.70, round(1.0 - div - 0.05, 2))
        pt, pq = "/tmp/divladder_t.fa", "/tmp/divladder_q.fa"
        write_pair(pt, pq, args.bp, div, args.seed)
        d_text, e_text = run_pair(pt, pq, pct)
        d_rows, e_rows = parse_rows(d_text), parse_rows(e_text)
        common = set(d_rows) & set(e_rows)
        if not common:
            print(f"| {div:.2f} | {pct} | 0 | - | - | - | - | - |")
            continue
        n_diff = sum(1 for k in common if d_rows[k][1] != e_rows[k][1])
        deltas = [e_rows[k][0] - d_rows[k][0] for k in common]
        qlen = args.bp   # approx (derived seq length differs slightly)
        cov_d = coverage(d_rows, qlen)
        cov_e = coverage(e_rows, qlen)
        print(f"| {div:.2f} | {pct} | {len(common)} "
              f"| {n_diff / len(common):.3f} "
              f"| {np.mean(deltas):+.5f} | {max(deltas):+.5f} "
              f"| {cov_d:.4f} | {cov_e:.4f} |")


if __name__ == "__main__":
    main()
