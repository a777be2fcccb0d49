"""Scale demo with a memory ceiling.

Generates a >=100 Mb synthetic genome pair (2% SNPs + 0.2% small
indels + a 500 kb inversion + a 1 Mb deletion + a 300 kb duplication),
writes BOTH as spec-conforming BGZF FASTA (+ .fai), runs the full CLI
pipeline in a subprocess while recording its peak RSS, then validates
the output: every sampled CIGAR must replay exactly against the
inputs and query coverage must exceed the floor.

Usage:
  python scripts/scale_demo.py [--bp 100000000] [--rss-gb 8]
                               [--keep-tmp] [--sample 200]

Exits nonzero if peak RSS exceeds the ceiling, a sampled CIGAR fails
replay, or coverage is below --min-coverage (default 0.95). The
measured row goes into BASELINE.md.

Reference bars: north-star configs 4-5 (gigabase WGA in minutes-hours
on one node, README.md:13-15) and the mapping-phase memory discipline
(docs/MAP_COMPACT.md:5).
"""

import argparse
import os
import resource
import struct
import subprocess
import sys
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

ACGT = np.frombuffer(b"ACGT", np.uint8)


def bgzf_compress_to(path: str, data: bytes, block: int = 60000):
    """Minimal BGZF writer (spec blocks + EOF marker), streaming, with
    the block index bgzip -i writes beside it (path + ".gzi": u64 count,
    then (compressed, uncompressed) u64 offsets of every block after the
    first)."""
    starts = []
    coff = 0
    with open(path, "wb") as fh:
        for i in range(0, len(data), block):
            chunk = data[i:i + block]
            co = zlib.compressobj(6, zlib.DEFLATED, -15)
            comp = co.compress(chunk) + co.flush()
            total = 12 + 6 + len(comp) + 8
            hdr = struct.pack("<4BI2BH2B2H", 0x1f, 0x8b, 8, 4, 0, 0, 0,
                              6, 66, 67, 2, total - 1)
            fh.write(hdr + comp + struct.pack(
                "<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk)))
            starts.append((coff, i))
            coff += total
        fh.write(bytes.fromhex(
            "1f8b08040000000000ff0600424302001b0003000000000000000000"))
    with open(path + ".gzi", "wb") as fh:
        fh.write(struct.pack("<Q", max(len(starts) - 1, 0)))
        for c, u in starts[1:]:
            fh.write(struct.pack("<QQ", c, u))


def write_fasta_bgzf(path: str, name: str, arr: np.ndarray):
    seq = ACGT[arr]
    lines = [f">{name}\n".encode()]
    off = len(lines[0])
    lb = 60
    n = len(seq)
    # vectorized line splitting
    body = bytearray()
    nl = np.full((n + lb - 1) // lb, 0, np.uint8)
    rows = np.full(((n + lb - 1) // lb, lb + 1), ord("\n"), np.uint8)
    pad = rows.shape[0] * lb - n
    flat = np.concatenate([seq, np.zeros(pad, np.uint8)])
    rows[:, :lb] = flat.reshape(-1, lb)
    body = rows.tobytes()
    if pad:
        # trim the padding from the final line (keep its newline)
        last_len = lb - pad
        body = body[: (rows.shape[0] - 1) * (lb + 1)] + \
            rows[-1, :last_len].tobytes() + b"\n"
    bgzf_compress_to(path, lines[0] + body)
    with open(path + ".fai", "w") as fh:
        fh.write(f"{name}\t{n}\t{off}\t{lb}\t{lb + 1}\n")
    del nl


def make_pair(bp: int, seed: int):
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, 4, bp, dtype=np.int8).astype(np.uint8)
    der = anc.copy()
    # 2% SNPs
    snp = rng.random(bp) < 0.02
    der[snp] = (der[snp] + rng.integers(1, 4, int(snp.sum()),
                                        dtype=np.int8).astype(np.uint8)) % 4
    # 0.2% small indels: delete 1-5 bp at random sites (vectorized via mask)
    delmask = np.ones(bp, bool)
    sites = rng.choice(bp - 10, bp // 1000, replace=False)
    for w in range(5):
        delmask[sites[rng.random(len(sites)) < 0.5] + w] = False
    der = der[delmask[:len(der)]]
    # structural events (positions relative to bp)
    inv_a, inv_l = bp // 3, 500_000
    der[inv_a:inv_a + inv_l] = 3 - der[inv_a:inv_a + inv_l][::-1]
    del_a, del_l = 2 * bp // 3, 1_000_000
    der = np.concatenate([der[:del_a], der[del_a + del_l:]])
    dup_a, dup_l = bp // 5, 300_000
    der = np.concatenate([der[:dup_a + dup_l],
                          der[dup_a:dup_a + dup_l],
                          der[dup_a + dup_l:]])
    return anc, der


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bp", type=int, default=100_000_000)
    ap.add_argument("--rss-gb", type=float, default=8.0)
    ap.add_argument("--min-coverage", type=float, default=0.95)
    ap.add_argument("--sample", type=int, default=200)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--keep-tmp", action="store_true")
    args = ap.parse_args()

    tdir = "/tmp/wfmash-tpu-scale"
    os.makedirs(tdir, exist_ok=True)
    pt = os.path.join(tdir, "anc.fa.gz")
    pq = os.path.join(tdir, "der.fa.gz")
    out_paf = os.path.join(tdir, "out.paf")

    print(f"[scale] generating {args.bp / 1e6:.0f} Mb pair ...",
          flush=True)
    t0 = time.time()
    anc, der = make_pair(args.bp, args.seed)
    write_fasta_bgzf(pt, "anc", anc)
    write_fasta_bgzf(pq, "der", der)
    print(f"[scale] wrote BGZF inputs in {time.time() - t0:.1f}s "
          f"({os.path.getsize(pt) / 1e6:.0f} MB + "
          f"{os.path.getsize(pq) / 1e6:.0f} MB)", flush=True)

    base = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    t0 = time.time()
    with open(out_paf, "w") as fh:
        r = subprocess.run(
            [sys.executable, "-m", "wfmash_tpu", pt, pq, "-t", "1"],
            stdout=fh, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
    wall = time.time() - t0
    if r.returncode != 0:
        print(r.stderr[-2000:])
        sys.exit(1)
    peak = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    peak_gb = peak / 1e6      # ru_maxrss is KB on linux
    print(f"[scale] pipeline wall {wall:.1f}s, child peak RSS "
          f"{peak_gb:.2f} GB (baseline before run {base / 1e6:.2f} GB)",
          flush=True)

    # -- validate ----------------------------------------------------------
    from wfmash_tpu.align import cigar as C
    from wfmash_tpu.sketch.kmers import reverse_complement

    anc_b = ACGT[anc].tobytes()
    der_b = ACGT[der].tobytes()
    rows = [l for l in open(out_paf) if "\tcg:Z:" in l]
    rng = np.random.default_rng(0)
    idx = rng.choice(len(rows), min(args.sample, len(rows)),
                     replace=False)
    n_checked = 0
    for i in idx:
        f = rows[int(i)].rstrip("\n").split("\t")
        cg = next(c[5:] for c in f[12:] if c.startswith("cg:Z:"))
        ops = C.parse(cg)
        qs, qe = int(f[2]), int(f[3])
        ts = int(f[7])
        if f[4] == "-":
            q = bytes(reverse_complement(bytearray(der_b)))
            q_start = len(der_b) - qe
        else:
            q = der_b
            q_start = qs
        assert C.validate(ops, q, anc_b, q_start, ts), \
            f"CIGAR replay failed on row {i}"
        n_checked += 1
    # coverage on the query axis
    iv = sorted((int(l.split("\t")[2]), int(l.split("\t")[3]))
                for l in rows)
    cov, end = 0, 0
    for a, b in iv:
        a = max(a, end)
        if b > a:
            cov += b - a
            end = b
    cov_frac = cov / len(der_b)
    mean_gi = float(np.mean([
        float(next(c[5:] for c in l.split("\t")[12:]
                   if c.startswith("gi:f:"))) for l in rows]))
    print(f"[scale] {len(rows)} rows, {n_checked} CIGARs replay-exact, "
          f"coverage {cov_frac:.4f}, mean gi {mean_gi:.4f}", flush=True)

    ok = True
    if peak_gb > args.rss_gb:
        print(f"[scale] FAIL: peak RSS {peak_gb:.2f} GB > ceiling "
              f"{args.rss_gb} GB")
        ok = False
    if cov_frac < args.min_coverage:
        print(f"[scale] FAIL: coverage {cov_frac:.4f} < "
              f"{args.min_coverage}")
        ok = False
    if not args.keep_tmp:
        for p in (pt, pq, pt + ".fai", pq + ".fai", out_paf):
            try:
                os.unlink(p)
            except OSError:
                pass
    print(f"[scale] {'OK' if ok else 'FAIL'}: {args.bp / 1e6:.0f} Mb "
          f"pair, wall {wall:.1f}s, peak RSS {peak_gb:.2f} GB "
          f"(ceiling {args.rss_gb} GB)")
    sys.exit(0 if ok else 2)


if __name__ == "__main__":
    main()
