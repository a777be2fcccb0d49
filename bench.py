"""Benchmark: the reference's headline workload, end to end, on one GPU.

    python bench.py --fasta LPA.subset.fa.gz

Runs `wfmash LPA.subset.fa.gz -p 80 -n 5` — upstream's performance test
(doc/performance-tuning.md; best published number 5.971 s wall / 42.3 s
user on an 8-core AVX2 Ryzen 3700X, static+native build) — through the
full pipeline, plus the segment solver on a seeded anchored-segment
load. The FASTA is upstream's data/LPA.subset.fa.gz (with .fai/.gzi).

Everything runs in this one process, which holds the card; without a
GPU the script exits non-zero. Every result line carries the device as
JAX reports it and the card's name and power limit from nvidia-smi.

Metrics (one JSON line each, headline LAST):
  1. seg_solver_throughput      — the tiered segment solver on 4096
     seeded anchored segments: Mbp/s and swept Gcells/s (levels x band
     lanes x 5 states, counted from the solver's own level counts)
  2. lpa_exact_align_cpu        — exact mode (WFMASH_TPU_HOST_SCORE_CAP=0)
     map+align CPU seconds (vs_baseline = 42.3 / value)
  3. lpa_allvsall_e2e_warm_wall — median map+align wall of >= 3 repeats
     after one warm pass (vs_baseline = 5.971 / value)
"""

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

BASELINE_WALL = 5.971    # s, reference static+native build, 8C Ryzen
BASELINE_USER = 42.3     # s user on those 8 cores (same run)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_info() -> dict:
    """The device as JAX reports it, plus nvidia-smi's name and power
    limit. Raises unless JAX's first device is a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: JAX found no GPU (first device: "
                         f"{devs[0].platform})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi.stdout.strip()}


def emit(device, metric, value, unit, vs_baseline, **extra):
    line = {"metric": metric, "value": value, "unit": unit,
            "vs_baseline": vs_baseline, "device": device}
    line.update(extra)
    print(json.dumps(line), flush=True)


def seg_solver_throughput():
    """Seeded anchored-segment load (4096 ~270 bp segments, 5% SNPs + 1%
    deletions) through the tiered segment solver; best of 2 warm runs."""
    from wfmash_tpu.align.wfa_np import Penalties
    from wfmash_tpu.align.wfa_seg import TieredSegmentSolver
    from wfmash_tpu.utils import perf

    rng = np.random.default_rng(1)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    jobs = []
    for _ in range(4096):
        q = rng.integers(0, 4, int(rng.integers(200, 340))).astype(np.uint8)
        t = q.copy()
        snp = rng.random(len(t)) < 0.05
        t[snp] = (t[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        t = np.delete(t, np.nonzero(rng.random(len(t)) < 0.01)[0])
        jobs.append((acgt[q].tobytes(), acgt[t].tobytes(), None))
    solver = TieredSegmentSolver(Penalties(5, 8, 2, 24, 1))
    n_ok = sum(r is not None for r in solver.solve(jobs))  # compile + warm
    best, cells = float("inf"), 0.0
    for _ in range(2):
        perf.reset()
        t0 = time.perf_counter()
        solver.solve(jobs)
        wall = time.perf_counter() - t0
        if wall < best:
            best, cells = wall, perf.get("align.device_cells")
    bp = sum(len(q) for q, _, _ in jobs)
    return dict(gcells=cells / best / 1e9, mbp_s=bp / best / 1e6,
                n_ok=n_ok, wall_s=best)


def run_e2e_once(fasta: str, threads: int, tmp: str):
    """One (map, align) pass; returns (map_wall, align_wall, n_rows,
    align_out_text)."""
    from wfmash_tpu.align.engine import run_alignment
    from wfmash_tpu.params import AlignParams, MapParams
    from wfmash_tpu.runner import run_mapping

    mp = MapParams(
        ref_sequences=[fasta], query_sequences=[fasta],
        percentage_identity=0.80, auto_pct_identity=False,
        num_mappings_for_segment=5, threads=threads,
    ).finalize()
    t0 = time.perf_counter()
    buf = io.StringIO()
    run_mapping(mp, buf)
    map_wall = time.perf_counter() - t0
    map_paf = os.path.join(tmp, "map.paf")
    with open(map_paf, "w") as fh:
        fh.write(buf.getvalue())

    # finalize() applies the reference's padding rules (min(w, 5000)
    # per side, parse_args.hpp:593-621) — benchmarking unpadded records
    # would understate the align work vs the reference's own runs
    ap = AlignParams(
        ref_sequences=[fasta], query_sequences=[fasta],
        mashmap_paf_file=map_paf, threads=threads,
    ).finalize(mp.window_length)
    t0 = time.perf_counter()
    out = io.StringIO()
    run_alignment(ap, out)
    align_wall = time.perf_counter() - t0
    return map_wall, align_wall, out.getvalue().count("\n"), out.getvalue()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fasta", required=True,
                    help="upstream's data/LPA.subset.fa.gz (+ .fai/.gzi)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    from wfmash_tpu.utils import jaxcache

    jaxcache.enable()
    dev = device_info()
    log(f"[bench] device {dev}")
    threads = min(8, os.cpu_count() or 1)

    segk = seg_solver_throughput()
    emit(dev, "seg_solver_throughput", segk["mbp_s"],
         "Mbp/s on 4096 anchored segments (best of 2 warm runs)", None,
         gcells_per_s=segk["gcells"], n_ok=segk["n_ok"],
         wall_s=segk["wall_s"])

    with tempfile.TemporaryDirectory() as tmp:
        # warm pass (absorbs native-lib builds and compiles)
        mw, aw, n_rows, out0 = run_e2e_once(args.fasta, threads, tmp)
        log(f"[bench] warm pass: map {mw:.2f}s + align {aw:.2f}s, "
            f"{n_rows} records")
        assert n_rows > 2000, "suspiciously few aligned records"

        totals = []
        for r in range(args.reps):
            mw, aw, _, out_r = run_e2e_once(args.fasta, threads, tmp)
            assert out_r == out0, "non-deterministic output"
            totals.append(mw + aw)
            log(f"[bench] repeat {r + 1}/{args.reps}: map {mw:.2f}s + "
                f"align {aw:.2f}s = {mw + aw:.2f}s wall")

        # exact-vs-exact: CPU seconds against the reference's 42.3 s user
        os.environ["WFMASH_TPU_HOST_SCORE_CAP"] = "0"
        try:
            cpu0 = time.process_time()
            run_e2e_once(args.fasta, 1, tmp)
            exact_cpu = time.process_time() - cpu0
        finally:
            del os.environ["WFMASH_TPU_HOST_SCORE_CAP"]
    emit(dev, "lpa_exact_align_cpu", exact_cpu,
         "CPU-s, exact mode (HOST_SCORE_CAP=0) map+align (reference exact "
         "default: 42.3 CPU-s user on 8 cores)",
         BASELINE_USER / exact_cpu)

    med = statistics.median(totals)
    band = f"{min(totals):.2f}..{max(totals):.2f}"
    emit(dev, "lpa_allvsall_e2e_warm_wall", med,
         f"s (map+align, median of {args.reps} repeats, band {band}, "
         f"lower is better)", BASELINE_WALL / med,
         threads=threads, band=band)


if __name__ == "__main__":
    main()
