"""In-suite scale regression: a ~6 Mb variant of
scripts/scale_demo.py with the same assertions — peak-RSS ceiling,
sampled CIGAR replay, query-coverage floor — so the 100 Mb claim has
standing coverage. Reference bars: memory discipline
(/root/reference/docs/MAP_COMPACT.md:5) and the scerevisiae coverage
gates (/root/reference/CMakeLists.txt:446-459, blob absent here).

Runs the full CLI in a subprocess (fresh process = honest RSS), on the
same synthetic event mix as the demo: 2% SNPs, 0.2% small indels, a
500 kb inversion, a 1 Mb deletion, a 300 kb duplication — at 6 Mb those
structural events are proportionally larger than at 100 Mb, which only
makes the mapping/alignment job harder.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

BP = 6_000_000
RSS_CEILING_GB = 1.6          # 100 Mb demo holds < 8 GB; ~linear in bp
MIN_COVERAGE = 0.95
N_SAMPLE = 60

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def scale_pair(tmp_path_factory):
    from scale_demo import make_pair, write_fasta_bgzf

    tdir = tmp_path_factory.mktemp("scale")
    anc, der = make_pair(BP, seed=42)
    pt = str(tdir / "anc.fa.gz")
    pq = str(tdir / "der.fa.gz")
    write_fasta_bgzf(pt, "anc", anc)
    write_fasta_bgzf(pq, "der", der)
    return anc, der, pt, pq, tdir


def test_scale_6mb_rss_and_fidelity(scale_pair):
    anc, der, pt, pq, tdir = scale_pair
    out_paf = str(tdir / "out.paf")
    # nested shim so the RSS high-water mark covers ONLY this pipeline
    # run, not every child the pytest session spawned before it
    shim = (
        "import resource, subprocess, sys\n"
        "r = subprocess.run(sys.argv[1:])\n"
        "print('PEAK_KB=%d' % resource.getrusage("
        "resource.RUSAGE_CHILDREN).ru_maxrss, file=sys.stderr)\n"
        "sys.exit(r.returncode)\n"
    )
    with open(out_paf, "w") as fh:
        r = subprocess.run(
            [sys.executable, "-c", shim, sys.executable, "-m",
             "wfmash_tpu", pt, pq, "-t", "1"],
            stdout=fh, stderr=subprocess.PIPE, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=REPO,
                     JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    peak_kb = next(int(line[8:]) for line in r.stderr.splitlines()
                   if line.startswith("PEAK_KB="))
    peak_gb = peak_kb / 1e6
    assert peak_gb < RSS_CEILING_GB, (
        f"peak RSS {peak_gb:.2f} GB over the {RSS_CEILING_GB} GB ceiling")

    from wfmash_tpu.align import cigar as C
    from wfmash_tpu.sketch.kmers import reverse_complement

    anc_b = ACGT[anc].tobytes()
    der_b = ACGT[der].tobytes()
    rows = [ln for ln in open(out_paf) if "\tcg:Z:" in ln]
    assert rows, "no aligned rows"
    rng = np.random.default_rng(0)
    der_rc = None
    for i in rng.choice(len(rows), min(N_SAMPLE, len(rows)),
                        replace=False):
        f = rows[int(i)].rstrip("\n").split("\t")
        cg = next(c[5:] for c in f[12:] if c.startswith("cg:Z:"))
        ops = C.parse(cg)
        qs, qe, ts = int(f[2]), int(f[3]), int(f[7])
        if f[4] == "-":
            if der_rc is None:
                der_rc = bytes(reverse_complement(
                    np.frombuffer(der_b, np.uint8)))
            q, q_start = der_rc, len(der_b) - qe
        else:
            q, q_start = der_b, qs
        assert C.validate(ops, q, anc_b, q_start, ts), \
            f"CIGAR replay failed on row {i}"

    # query-axis coverage (union of [qs, qe) intervals)
    iv = sorted((int(ln.split("\t")[2]), int(ln.split("\t")[3]))
                for ln in rows)
    cov = end = 0
    for a, b in iv:
        a = max(a, end)
        if b > a:
            cov += b - a
            end = b
    cov_frac = cov / len(der_b)
    assert cov_frac > MIN_COVERAGE, f"coverage {cov_frac:.4f}"
