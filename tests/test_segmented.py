"""Anchored segmented alignment (the device form of wflambda) tests.

Validity bar: every stitched CIGAR must replay exactly. Quality bar:
on realistic mutated blocks the stitched score must be optimal or
within a small factor of the DP optimum (divergence from exact biWFA
is a documented ledger item)."""

import numpy as np

from wfmash_tpu.align import cigar as C
from wfmash_tpu.align import segmented as S
from wfmash_tpu.align.biwfa import HostWfaEngine
from wfmash_tpu.align.wfa_np import Penalties, dp_align, score_cigar

from test_wfa import make_pair
from util import mutate, random_dna

PATCH = Penalties(5, 8, 2, 24, 1)


def make_engine(**kw):
    return S.SegmentedEngine(PATCH, HostWfaEngine(PATCH), **kw)


def test_anchor_chain_monotone():
    rng = np.random.default_rng(0)
    t = np.frombuffer(random_dna(rng, 5000), np.uint8)
    q = np.frombuffer(mutate(rng, t.tobytes(), 0.05), np.uint8)
    qp, tp = S.find_anchors(q, t)
    assert len(qp) > 20
    assert np.all(np.diff(qp) > 0) and np.all(np.diff(tp) > 0)
    # anchors are exact matches
    for i in range(0, len(qp), max(1, len(qp) // 10)):
        assert q[qp[i]:qp[i] + S.ANCHOR_K].tobytes() == \
            t[tp[i]:tp[i] + S.ANCHOR_K].tobytes()


def test_segmented_replay_exact_and_near_optimal():
    rng = np.random.default_rng(1)
    eng = make_engine()
    t = random_dna(rng, 6000)
    q = mutate(rng, t, 0.05)
    ops = eng.align(q, t)
    assert ops is not None
    assert C.validate(ops, q, t, 0, 0)
    got = score_cigar(ops, PATCH)
    # exact optimum from the (fast) vectorized exact WFA
    from wfmash_tpu.align.wfa_vec import wfa_align as wfa_vec_align

    opt, _ = wfa_vec_align(q, t, PATCH)
    assert got <= opt * 1.05 + 20, (got, opt)
    assert eng.stats["segments"] > 10


def test_segmented_with_structural_indel():
    """A 900bp insertion splits the anchor chain; the oversize middle
    piece must escalate to the exact engine and still stitch exactly."""
    rng = np.random.default_rng(2)
    eng = make_engine()
    t = random_dna(rng, 5000)
    ins = random_dna(rng, 900)
    q = mutate(rng, t[:2500], 0.03) + ins + mutate(rng, t[2500:], 0.03)
    ops = eng.align(q, t)
    assert ops is not None
    assert C.validate(ops, q, t, 0, 0)
    # the insertion must appear as a large I run
    assert max((n for n, op in ops if op == "I"), default=0) > 700


def test_segmented_small_blocks_delegate():
    rng = np.random.default_rng(3)
    eng = make_engine()
    q, t = make_pair(rng, 400, sub=0.05, indel=0.02, max_indel=6)
    ops = eng.align(q, t)
    from wfmash_tpu.align.wfa_vec import wfa_align as wfa_vec_align

    s_opt, _ = wfa_vec_align(q, t, PATCH)
    assert score_cigar(ops, PATCH) == s_opt
    # round 3: small blocks go to the device solver as ONE whole-block
    # segment (exact WFA) instead of the host exact path
    assert eng.stats["segments"] == 1
    assert eng.stats["exact_blocks"] == 0


def test_segmented_unanchorable_falls_back():
    rng = np.random.default_rng(4)
    eng = make_engine()
    q = random_dna(rng, 1500)
    t = random_dna(rng, 1500)   # unrelated -> no anchor chain of cuts
    ops = eng.align(q, t)
    assert ops is not None
    assert C.validate(ops, q, t, 0, 0)
    from wfmash_tpu.align.wfa_vec import wfa_align as wfa_vec_align

    assert score_cigar(ops, PATCH) == wfa_vec_align(q, t, PATCH)[0]


def test_segmented_batch_mixed():
    rng = np.random.default_rng(5)
    eng = make_engine()
    jobs = []
    for i in range(4):
        t = random_dna(rng, 3000 + 500 * i)
        q = mutate(rng, t, 0.04)
        jobs.append((q, t, None))
    res = eng.align_batch(jobs)
    for (q, t, _), ops in zip(jobs, res):
        assert ops is not None
        assert C.validate(ops, q, t, 0, 0)


def test_inversion_detection():
    """A 400bp inverted region inside a high-identity block must be
    detected by the rev-comp patch try: the main CIGAR stays valid and
    an inversion record with matching coordinates appears."""
    from wfmash_tpu.sketch.kmers import reverse_complement

    rng = np.random.default_rng(6)
    eng = make_engine()
    t = random_dna(rng, 6000)
    inv = bytes(reverse_complement(bytearray(t[3000:3400])))
    q = t[:3000] + inv + t[3400:]
    ops = eng.align(q, t)
    assert ops is not None
    assert C.validate(ops, q, t, 0, 0)
    assert eng.stats["inversions"] >= 1
    rec = eng.inversions[0]
    # the recorded region covers (most of) the inverted stretch
    assert rec["qa"] <= 3100 and rec["qb"] >= 3300
    # the inversion CIGAR replays against revcomp(query region) x target
    rq = bytes(reverse_complement(bytearray(q[rec["qa"]:rec["qb"]])))
    assert C.validate(rec["ops"], rq, t[rec["ta"]:rec["tb"]], 0, 0)


def test_inversion_row_e2e(tmp_path):
    """End-to-end: mapping + alignment over a genome pair with an
    inversion emits a pt:Z:true iv:Z:true PAF row."""
    import io

    from wfmash_tpu.align.engine import run_alignment
    from wfmash_tpu.params import AlignParams, MapParams
    from wfmash_tpu.runner import run_mapping
    from wfmash_tpu.sketch.kmers import reverse_complement
    from util import write_fasta

    rng = np.random.default_rng(7)
    t = random_dna(rng, 20_000)
    invseg = bytes(reverse_complement(bytearray(t[9_000:9_400])))
    q = mutate(rng, t[:9_000], 0.01) + invseg + mutate(rng, t[9_400:], 0.01)
    tfa, qfa = tmp_path / "t.fa", tmp_path / "q.fa"
    write_fasta(tfa, {"t1": t})
    write_fasta(qfa, {"q1": q})
    mp = MapParams(ref_sequences=[str(tfa)], query_sequences=[str(qfa)],
                   percentage_identity=0.9, auto_pct_identity=False,
                   threads=1).finalize()
    buf = io.StringIO()
    run_mapping(mp, buf)
    mpaf = tmp_path / "m.paf"
    mpaf.write_text(buf.getvalue())
    import os

    os.environ["WFMASH_TPU_WFA_ENGINE"] = "auto"
    os.environ["WFMASH_TPU_SEGMENTED"] = "1"   # auto picks native on CPU
    try:
        ap = AlignParams(ref_sequences=[str(tfa)],
                         query_sequences=[str(qfa)],
                         mashmap_paf_file=str(mpaf))
        out = io.StringIO()
        run_alignment(ap, out)
    finally:
        os.environ.pop("WFMASH_TPU_WFA_ENGINE", None)
        os.environ.pop("WFMASH_TPU_SEGMENTED", None)
    rows = out.getvalue().splitlines()
    assert rows
    iv = [r for r in rows if "iv:Z:true" in r]
    assert iv, "no inversion row emitted"
    f = iv[0].split("\t")
    assert f[4] == "-" and "pt:Z:true" in iv[0]
    assert 8_800 <= int(f[2]) <= 9_200 and 9_200 <= int(f[3]) <= 9_600


def test_strict_parity_suppresses_inversion_rows(tmp_path):
    """--strict-parity / WFMASH_TPU_STRICT_PARITY=1 must produce a PAF
    with no pt:Z/iv:Z rows (dead-upstream outputs) while keeping the
    main alignment rows intact."""
    import io

    from wfmash_tpu.align.engine import run_alignment
    from wfmash_tpu.params import AlignParams, MapParams
    from wfmash_tpu.runner import run_mapping
    from wfmash_tpu.sketch.kmers import reverse_complement
    from util import write_fasta

    rng = np.random.default_rng(7)
    t = random_dna(rng, 20_000)
    invseg = bytes(reverse_complement(bytearray(t[9_000:9_400])))
    q = mutate(rng, t[:9_000], 0.01) + invseg + mutate(rng, t[9_400:], 0.01)
    tfa, qfa = tmp_path / "t.fa", tmp_path / "q.fa"
    write_fasta(tfa, {"t1": t})
    write_fasta(qfa, {"q1": q})
    mp = MapParams(ref_sequences=[str(tfa)], query_sequences=[str(qfa)],
                   percentage_identity=0.9, auto_pct_identity=False,
                   threads=1).finalize()
    buf = io.StringIO()
    run_mapping(mp, buf)
    mpaf = tmp_path / "m.paf"
    mpaf.write_text(buf.getvalue())
    import os

    os.environ["WFMASH_TPU_WFA_ENGINE"] = "auto"
    os.environ["WFMASH_TPU_SEGMENTED"] = "1"   # auto picks native on CPU
    try:
        ap = AlignParams(ref_sequences=[str(tfa)],
                         query_sequences=[str(qfa)],
                         mashmap_paf_file=str(mpaf),
                         strict_parity=True)
        out = io.StringIO()
        run_alignment(ap, out)
    finally:
        os.environ.pop("WFMASH_TPU_WFA_ENGINE", None)
        os.environ.pop("WFMASH_TPU_SEGMENTED", None)
    rows = out.getvalue().splitlines()
    assert rows, "no alignment rows at all"
    assert not [r for r in rows if "iv:Z:" in r or "pt:Z:" in r]


def test_structural_gap_placement():
    """A piece whose skew exceeds every device band envelope takes the
    k-mer placement path: flanks as plain gap runs + device middle —
    replay-exact, with the gap where the votes put it."""
    rng = np.random.default_rng(44)
    eng = make_engine()
    t = random_dna(rng, 9000)
    junk = random_dna(rng, 3000)            # skew 3000 > K4 - margin
    q = mutate(rng, t[:6000], 0.02) + junk + mutate(rng, t[6000:], 0.02)
    ops = eng.align(q, t)
    assert ops is not None
    assert C.validate(ops, q, t, 0, 0)
    assert max((n for n, op in ops if op == "I"), default=0) > 2000


def test_fast_head_patch_score_identical():
    """Free-begin patches solved on the reversed sequences (the host
    engine's fast head-patch path) are score-identical to the forward
    free-begin solve, and the reversed CIGAR replays."""
    import numpy as np

    from wfmash_tpu.align import cigar as C
    from wfmash_tpu.align.biwfa import EndsFree, Penalties
    from wfmash_tpu.align.wfa_vec import wfa_align

    p = Penalties(5, 8, 2, 24, 1)
    rng = np.random.default_rng(17)
    lut = np.frombuffer(b"ACGT", np.uint8)
    for i in range(25):
        n = int(rng.integers(60, 1200))
        t = bytes(lut[rng.integers(0, 4, n)])
        q = bytearray(t)
        for _ in range(int(n * 0.08)):
            q[int(rng.integers(0, n))] = int(lut[rng.integers(0, 4)])
        q = bytes(q)
        tb = int(rng.integers(1, n))
        qb = int(rng.integers(1, n))
        s_fwd, _ = wfa_align(q, t, p,
                             EndsFree(target_begin=tb, query_begin=qb))
        s_rev, ops = wfa_align(q[::-1], t[::-1], p,
                               EndsFree(target_end=tb, query_end=qb))
        assert s_fwd == s_rev, (i, s_fwd, s_rev)
        ops = ops[::-1]
        # the reversed CIGAR consumes exactly the right suffix lengths
        # and replays against the forward sequences from its skip point
        (_, _, _, _, _, _, ref_len, q_len) = C.stats(ops)
        q_skip, t_skip = len(q) - q_len, len(t) - ref_len
        assert 0 <= q_skip <= qb and 0 <= t_skip <= tb, (i, q_skip, t_skip)
        assert C.validate(ops, q, t, q_skip, t_skip), i


def test_host_small_routing_bit_identical(monkeypatch):
    """WFMASH_TPU_SEG_HOST_SMALL=1 (native batch for ends-free patches,
    escalations, inversion tries) must produce byte-identical CIGARs and
    identical inversion records vs =0 (everything through the device
    solver) — the routing is a placement choice, not a semantics change."""
    from wfmash_tpu.align.wfa_np import EndsFree
    from wfmash_tpu.native import get_wfa_lib

    if get_wfa_lib() is None:
        import pytest

        pytest.skip("native WFA lib unavailable")
    rng = np.random.default_rng(7)
    t1 = random_dna(rng, 3000)
    q1 = mutate(rng, t1, 0.06)
    # block with an inversion candidate: reverse-complement a middle span
    t2 = bytearray(random_dna(rng, 2600))
    q2 = bytearray(mutate(rng, bytes(t2), 0.03))
    comp = {65: 84, 67: 71, 71: 67, 84: 65}
    inv = bytes(comp[b] for b in reversed(q2[1200:1500]))
    q2[1200:1500] = inv
    # ends-free patch jobs (head + tail erodes)
    jobs = [
        (q1, t1, None),
        (bytes(q2), bytes(t2), None),
        (q1[:180], t1[:195], EndsFree(target_begin=195, query_begin=180)),
        (q1[-170:], t1[-150:], EndsFree(target_end=150, query_end=170)),
    ]
    bounds = [None, None, 5 * 180 + 40, 5 * 170 + 40]
    results = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("WFMASH_TPU_SEG_HOST_SMALL", mode)
        eng = make_engine()
        got = eng.align_batch(jobs, bounds=bounds)
        results[mode] = (got, sorted(
            (d["ji"], d["qa"], d["qb"], d["ta"], d["tb"], tuple(map(tuple, d["ops"])))
            for d in eng.inversions))
        for (q, t, ef), ops in zip(jobs, got):
            assert ops is not None
            if ef is None:
                assert C.validate(ops, q, t, 0, 0)
    assert results["0"][0] == results["1"][0]
    assert results["0"][1] == results["1"][1]
