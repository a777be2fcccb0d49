"""Golden-data regression: the bundled 255bp reads reproduce the
reference's regression pairs (test/data/regression/reads.255bps.paf).

The golden file was produced by the reference binary; its exact flags
are unrecorded, so this checks structural parity — the same four read
pairs map, on the same strands, covering (nearly) the same spans — with
scaffold filtering off (tiny reads cannot form >=10 kb scaffold chains;
the reference clears all mappings in that case too,
mappingFilter.hpp:904-909).
"""

import io
import os

import pytest

from wfmash_tpu.params import MapParams
from wfmash_tpu.runner import run_mapping

DATA = "/root/reference/data/reads.255bps.fa.gz"
GOLDEN = "/root/reference/test/data/regression/reads.255bps.paf"

pytestmark = pytest.mark.skipif(
    not (os.path.exists(DATA) and os.path.exists(GOLDEN)),
    reason="reference data not available")


def test_reads_255bps_pairs_match_golden():
    mp = MapParams(
        ref_sequences=[DATA],
        query_sequences=[DATA],
        percentage_identity=0.70,
        auto_pct_identity=False,
        window_length=200,
        kmer_size=15,
        scaffold_gap=0,
    ).finalize()
    out = io.StringIO()
    run_mapping(mp, out)
    ours = set()
    for line in out.getvalue().splitlines():
        f = line.split("\t")
        # primary span only (>=150bp) — tail-fragment echoes are shorter
        if int(f[3]) - int(f[2]) >= 150:
            ours.add((f[0], f[5], f[4]))
    golden = set()
    for line in open(GOLDEN):
        f = line.split("\t")
        golden.add((f[0], f[5], f[4]))
    # golden lists each pair once (one direction); we map all-vs-all so
    # require each golden pair to appear in at least one direction
    for q, t, strand in golden:
        assert ((q, t, strand) in ours) or ((t, q, strand) in ours), (
            f"golden pair {q} vs {t} ({strand}) not found")


def _align_reads(map_out: str, sam=False, **overrides):
    """Run the align phase over a mapping PAF for the 255bps read set."""
    import io as _io

    from wfmash_tpu.align.engine import run_alignment
    from wfmash_tpu.params import AlignParams

    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".paf",
                                     delete=False) as fh:
        fh.write(map_out)
        path = fh.name
    ap = AlignParams(ref_sequences=[DATA], query_sequences=[DATA],
                     mashmap_paf_file=path, sam_format=sam, **overrides)
    out = _io.StringIO()
    run_alignment(ap, out)
    os.unlink(path)
    return out.getvalue()


def test_reads_255bps_golden_field_level():
    """Field-level golden comparison.

    Flag recovery was attempted (round 3): the generating invocation is
    unrecorded (the old `wfmash-short-reads-255bps-to-PAF` ctest exists
    only as a name in doc/performance-tuning.md:171; the regression dir
    is referenced by no current ctest and the checkout has no git
    history). A numeric search over k in 11..25 and sketch sizes
    20..4096 shows NO (k, s) makes float32 j2md reproduce even one
    consistent assignment for all four golden md:f values — they are
    merged-chain MEANS of per-fragment identities under unknown
    fragmentation, hence not invertible to flags. Per-field verdict:

    * cols 1, 2, 5, 6, 7 (names, lengths, strand): flag-independent ->
      asserted EXACTLY below;
    * cols 3/4, 8/9 (aligned spans): set by the old wflign ends-free
      force-extension to the read ends (the golden CIGARs' leading
      1I/22I/2=18D runs are its signature) — the live biWFA path trims
      those; asserted to >= 65% span overlap;
    * cols 10-12 (matches, block len, mapq) and gi/bi: functions of the
      CIGAR bytes, excused with them (empty WFA2-lib submodule = its
      exact tie-breaks are unrecoverable; our CIGARs are
      score-identical and replay-exact);
    * md:f: the non-invertible merged mean above; asserted via the
      mapping id within 0.03.

    Additionally the GOLDEN CIGARs replay exactly against the input
    sequences under our validator, and ours do too.
    """
    import gzip

    from wfmash_tpu.align import cigar as C
    from wfmash_tpu.sketch.kmers import normalize, reverse_complement

    mp = MapParams(
        ref_sequences=[DATA], query_sequences=[DATA],
        percentage_identity=0.70, auto_pct_identity=False,
        window_length=200, kmer_size=15, scaffold_gap=0,
    ).finalize()
    buf = io.StringIO()
    run_mapping(mp, buf)
    aligned = _align_reads(buf.getvalue())

    seqs = {}
    with gzip.open(DATA, "rt") as fh:
        name = None
        for line in fh:
            if line.startswith(">"):
                name = line[1:].split()[0]
                seqs[name] = []
            else:
                seqs[name].append(line.strip())
    seqs = {k: bytes(normalize(("".join(v)).encode())) for k, v in seqs.items()}

    ours = {}
    for line in aligned.splitlines():
        f = line.split("\t")
        cg = next(c[5:] for c in f if c.startswith("cg:Z:"))
        gi = float(next(c[5:] for c in f if c.startswith("gi:f:")))
        ours[(f[0], f[5])] = (f, cg, gi)

    n_rows = 0
    for line in open(GOLDEN):
        f = line.rstrip("\n").split("\t")
        q, t, strand = f[0], f[5], f[4]
        cg = next(c[5:] for c in f if c.startswith("cg:Z:"))
        gi = float(next(c[5:] for c in f if c.startswith("gi:f:")))

        # the golden CIGAR replays exactly against the input sequences
        ops = C.parse(cg)
        qseq = seqs[q]
        if strand == "-":
            qseq = bytes(reverse_complement(bytearray(qseq)))
            q_start = len(qseq) - int(f[3])
        else:
            q_start = int(f[2])
        assert C.validate(ops, qseq, seqs[t], q_start, int(f[7])), (
            f"golden CIGAR does not replay for {q} vs {t}")

        # our matching row (either direction)
        mine = ours.get((q, t)) or ours.get((t, q))
        assert mine is not None, f"golden pair {q} vs {t} missing"
        mf, mcg, mgi = mine
        if (q, t) in ours:
            # exact equality on every flag-independent column
            assert mf[0] == f[0] and mf[5] == f[5]          # names
            assert mf[1] == f[1] and mf[6] == f[6]          # lengths
            assert mf[4] == strand                          # strand
            # content check (replacing the old
            # >=65% span-overlap excuse): >=95% of the golden row's
            # aligned base pairs must be reproduced at IDENTICAL
            # (query,ref) coordinates (measured 0.956-0.996 per row;
            # the residue is the old binary's force-extended junk ends
            # — every golden CIGAR here starts/ends with a pure-indel
            # run — plus +-1-column WFA tie-break shifts), and our
            # span must CONTAIN the golden's solid-anchor hull (match
            # runs >= 8 bp) exactly — the golden's mapping era used
            # 200 bp force-extended fragments while the live path
            # covers the full homology, so ours is a superset.
            g_q0 = int(f[2]) if strand == "+" else int(f[1]) - int(f[3])
            gold_pairs = _aligned_pairs(ops, g_q0, int(f[7]))
            m_q0 = (int(mf[2]) if mf[4] == "+"
                    else int(mf[1]) - int(mf[3]))
            my_pairs = _aligned_pairs(C.parse(mcg), m_q0, int(mf[7]))
            frac = len(gold_pairs & my_pairs) / len(gold_pairs)
            assert frac >= 0.95, (q, t, frac)
            # solid hull: coordinates inside >=8bp '=' runs
            solid = _solid_hull(ops, g_q0, int(f[7]))
            if solid is not None:
                (sq0, sq1), (st0, st1) = solid
                assert m_q0 <= sq0 and sq1 <= m_q0 + sum(
                    nn for nn, op in C.parse(mcg) if op in "=XI"), \
                    (q, t, "query hull", sq0, sq1, m_q0)
                assert int(mf[7]) <= st0 and st1 <= int(mf[8]), \
                    (q, t, "target hull", st0, st1, mf[7], mf[8])
        assert abs(mgi - gi) <= 0.03, (q, t, mgi, gi)
        n_rows += 1
    assert n_rows == 4


def _solid_hull(ops, q0, r0):
    """(qmin,qmax),(rmin,rmax) over '='-runs of >= 8 bp, or None."""
    q, r = q0, r0
    qs, rs = [], []
    for n, op in ops:
        if op == "=" and n >= 8:
            qs += [q, q + n]
            rs += [r, r + n]
        if op in "=X":
            q += n
            r += n
        elif op == "I":
            q += n
        elif op == "D":
            r += n
    if not qs:
        return None
    return (min(qs), max(qs)), (min(rs), max(rs))


READS500 = "/root/reference/data/reads.500bps.fa.gz"
REFFA = "/root/reference/data/reference.fa.gz"
GOLDEN_SAM = ("/root/reference/test/data/regression/"
              "wfmash-short-reads-500bps-to-SAM.output")


def _aligned_pairs(ops, q0, r0):
    """Set of (query_pos, ref_pos) base pairs matched (=/X) by a CIGAR."""
    pairs = set()
    q, r = q0, r0
    for n, op in ops:
        if op in "=X":
            pairs.update((q + i, r + i) for i in range(n))
            q += n
            r += n
        elif op == "I":
            q += n
        elif op == "D":
            r += n
    return pairs


@pytest.mark.skipif(
    not (os.path.exists(READS500) and os.path.exists(GOLDEN_SAM)),
    reason="reference data not available")
def test_reads_500bps_sam_golden():
    """The 500bp-read SAM golden (reads.500bps vs 'sample'), field-level
    

    The golden rows carry the generating binary's ends-free
    force-extension signature (leading/trailing pure-indel runs like
    `10D…`/`…9I`, same as the 255bp goldens) which the live biWFA path
    trims, and WFA2-lib tie-breaks shift single-base indels by ±1
    column. Both effects move only a handful of base pairs, so the
    comparison is on the *aligned base pairs* themselves:

    * FLAG and RNAME: asserted exactly (flag-independent);
    * alignment content: ≥95% of each golden row's (query,ref) matched
      base pairs must be reproduced at identical coordinates by our row
      (measured: ≥0.97 on all 10; a position shift of even one read
      length would score ~0);
    * our CIGAR consumes the full read, and the golden CIGARs replay
      exactly against the inputs under our validator."""
    import gzip

    from wfmash_tpu.align import cigar as C
    from wfmash_tpu.align.engine import run_alignment
    from wfmash_tpu.params import AlignParams
    from wfmash_tpu.sketch.kmers import normalize

    golden = {}
    for line in open(GOLDEN_SAM):
        f = line.rstrip("\n").split("\t")
        golden[f[0]] = (int(f[1]), f[2], int(f[3]), f[5])
    assert len(golden) == 10

    mp = MapParams(
        ref_sequences=[REFFA], query_sequences=[READS500],
        percentage_identity=0.70, auto_pct_identity=False,
        window_length=500, kmer_size=15, scaffold_gap=0, split=False,
    ).finalize()
    buf = io.StringIO()
    run_mapping(mp, buf)

    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".paf",
                                     delete=False) as fh:
        fh.write(buf.getvalue())
        path = fh.name
    ap = AlignParams(ref_sequences=[REFFA], query_sequences=[READS500],
                     mashmap_paf_file=path, sam_format=True)
    out = io.StringIO()
    run_alignment(ap, out)
    os.unlink(path)

    ours = {}
    for line in out.getvalue().splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t")
        ours.setdefault(f[0], []).append((int(f[1]), f[2], int(f[3]), f[5]))

    # reference sequence for replaying golden CIGARs
    with gzip.open(REFFA, "rt") as fh:
        ref = "".join(l.strip() for l in fh if not l.startswith(">"))
    ref = bytes(normalize(ref.encode()))
    with gzip.open(READS500, "rt") as fh:
        reads = {}
        name = None
        for l in fh:
            if l.startswith(">"):
                name = l[1:].split()[0]
                reads[name] = []
            else:
                reads[name].append(l.strip())
    reads = {k: bytes(normalize("".join(v).encode()))
             for k, v in reads.items()}

    n = 0
    for qname, (flag, rname, pos, cig) in golden.items():
        assert rname == "sample"
        # golden CIGAR replays (0-based pos = pos - 1); flag 16 = the
        # alignment is against the reverse-complemented read
        from wfmash_tpu.sketch.kmers import reverse_complement

        ops = C.parse(cig)
        qseq = reads[qname]
        if flag & 16:
            qseq = bytes(reverse_complement(bytearray(qseq)))
        q_used = sum(nn for nn, op in ops if op in "=XI")
        assert q_used == len(qseq), (qname, q_used, len(qseq))
        assert C.validate(ops, qseq, ref, 0, pos - 1), qname
        rows = ours.get(qname)
        assert rows, f"{qname} unaligned in our SAM"
        gold_pairs = _aligned_pairs(ops, 0, pos - 1)
        best, best_ovl = None, -1.0
        for r in rows:
            ovl = len(gold_pairs
                      & _aligned_pairs(C.parse(r[3]), 0, r[2] - 1))
            if ovl > best_ovl:
                best, best_ovl = r, ovl
        # exact on the flag-independent fields
        assert best[1] == "sample", qname
        assert best[0] == flag, (qname, best[0], flag)
        # our CIGAR consumes the full read too
        ours_used = sum(nn for nn, op in C.parse(best[3])
                        if op in "=XI")
        assert ours_used == len(qseq), (qname, ours_used)
        # >=95% of the golden's aligned base pairs reproduced at
        # IDENTICAL (query,ref) coordinates (measured >=0.97 on all 10;
        # the residue is the golden's force-extended junk heads/tails
        # and +-1-column WFA tie-break shifts)
        frac = best_ovl / len(gold_pairs)
        assert frac >= 0.95, (qname, frac)
        n += 1
    assert n == 10
