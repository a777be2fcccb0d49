"""Full-history segment kernel (wfa_seg) vs the wfa_np spec.

The device backtrace must produce BIT-IDENTICAL CIGARs to the host
reference (same recurrences, same tie-breaks): the kernel replaces the
host leaf solver inside the exact engine, so byte equality — not just
score equality — is the bar. The CPU runs the plain-JAX solve."""

import numpy as np
import pytest

from wfmash_tpu.align.wfa_np import Penalties, wfa_align
from wfmash_tpu.align.wfa_seg import SegmentSolver

from test_wfa import make_pair
from util import random_dna

PATCH = Penalties(5, 8, 2, 24, 1)
WFLIGN = Penalties(2, 3, 1, 3, 1)


def _check(jobs, p, solver=None):
    solver = solver or SegmentSolver(p)
    got = solver.solve(jobs)
    for (q, t), ops in zip(jobs, got):
        s_ref, ops_ref = wfa_align(q, t, p)
        assert ops is not None, (len(q), len(t))
        assert ops == ops_ref, (len(q), len(t), ops[:5], ops_ref[:5])


def test_seg_small_batch_bit_identical():
    rng = np.random.default_rng(3)
    jobs = []
    for _ in range(8):
        n = int(rng.integers(40, 340))
        jobs.append(make_pair(rng, n, sub=0.05, indel=0.02, max_indel=8))
    _check(jobs, PATCH)


def test_seg_divergent_and_wflign_penalties():
    rng = np.random.default_rng(4)
    jobs = []
    for _ in range(4):
        n = int(rng.integers(100, 400))
        jobs.append(make_pair(rng, n, sub=0.15, indel=0.03, max_indel=10))
    _check(jobs, WFLIGN)


def test_seg_edge_cases():
    rng = np.random.default_rng(5)
    s = random_dna(rng, 300)
    jobs = [
        (s, s),                       # perfect match, score 0
        (s[:200], s[:200]),
        (b"", s[:50]),                # empty query -> pure D
        (s[:50], b""),                # empty target -> pure I
        (s[:64], bytes(64)),          # all-mismatch (zeros vs DNA)
        (s[:100] + s[180:300], s),    # clean 80bp deletion
        (s, s[:100] + s[180:300]),    # clean 80bp insertion
    ]
    _check(jobs, PATCH)


def test_seg_rejects_out_of_envelope():
    rng = np.random.default_rng(6)
    solver = SegmentSolver(PATCH)
    long = random_dna(rng, 600)       # > lseg-1
    got = solver.solve([(long, long)])
    assert got == [None]
    q = random_dna(rng, 500)
    t = q[:250]                       # |diff| = 250 >= K - 2*margin
    assert solver.solve([(q, t)]) == [None]


def test_seg_band_centering_covers_large_skew():
    """|m-n| up to K - 2*margin - 1 is solvable now that the band is
    re-centered per problem via sequence placement (round-3)."""
    from wfmash_tpu.align.wfa_np import wfa_align

    rng = np.random.default_rng(6)
    q = random_dna(rng, 400)
    t = q[:200]                       # old envelope rejected this
    got = solver_solve_one(q, t)
    _, ref = wfa_align(q, t, PATCH)
    assert got == ref


def solver_solve_one(q, t):
    solver = SegmentSolver(PATCH)
    return solver.solve([(q, t)])[0]


def test_seg_score_cap_flags_failure():
    rng = np.random.default_rng(7)
    q = random_dna(rng, 400)
    t = random_dna(rng, 400)          # unrelated: score >> smax
    solver = SegmentSolver(PATCH, smax=64)
    assert solver.solve([(q, t)]) == [None]


def test_seg_group_padding_many():
    """17 problems -> two PB=16 groups with padding lanes."""
    rng = np.random.default_rng(8)
    jobs = []
    for _ in range(17):
        n = int(rng.integers(30, 200))
        jobs.append(make_pair(rng, n, sub=0.08, indel=0.02, max_indel=5))
    _check(jobs, PATCH)


def test_seg_fuzz_tie_breaks():
    """Two-letter alphabet sequences maximize equal-score alternatives;
    the device backtrace must still match wfa_np's documented priority
    byte-for-byte."""
    rng = np.random.default_rng(11)
    jobs = []
    for _ in range(12):
        n = int(rng.integers(20, 180))
        t = bytes(rng.choice([65, 67], size=n).astype(np.uint8))
        q = bytearray(t)
        for _ in range(int(rng.integers(0, 8))):
            pos = int(rng.integers(0, len(q)))
            r = rng.random()
            if r < 0.4:
                q[pos] = 67 if q[pos] == 65 else 65
            elif r < 0.7:
                q.insert(pos, int(rng.choice([65, 67])))
            elif len(q) > 2:
                del q[pos]
        jobs.append((bytes(q), t))
    _check(jobs, PATCH)
    _check(jobs, WFLIGN)


def test_tiered_solver_bit_identical():
    """Tier-1 (PB=64,K=128,smax=128) results and tier-2 escalations must
    both be bit-identical to wfa_np."""
    from wfmash_tpu.align.wfa_seg import TieredSegmentSolver

    rng = np.random.default_rng(19)
    jobs = []
    for _ in range(6):
        n = int(rng.integers(60, 300))
        jobs.append(make_pair(rng, n, sub=0.04, indel=0.01, max_indel=5))
    # a big-gap pair tier 1 must reject (|m-n| = 100 > K1/2) and tier 2
    # must solve
    s = random_dna(rng, 400)
    jobs.append((s, s[:150] + s[250:]))
    sol = TieredSegmentSolver(PATCH)
    got = sol.solve(jobs)
    for (q, t), ops in zip(jobs, got):
        _, ref = wfa_align(q, t, PATCH)
        assert ops == ref, (len(q), len(t))


# ---------------------------------------------------------------------------
# Round-3: ends-free support (boundary patches, structural gaps) and the
# deep tier — all bit-identical to the wfa_np spec.
# ---------------------------------------------------------------------------

def _check_ef(jobs, p, solver):
    got = solver.solve(jobs)
    for (q, t, ef), ops in zip(jobs, got):
        s_ref, ops_ref = wfa_align(q, t, p, ef)
        assert ops is not None, (len(q), len(t), ef, s_ref)
        assert ops == ops_ref, (len(q), len(t), ef, ops[:5], ops_ref[:5])


def test_seg_ends_free_patches_bit_identical():
    """Head/tail boundary-patch jobs (free begin / free end on both
    sequences, wflign.cpp:240-418 shapes)."""
    from wfmash_tpu.align.wfa_np import EndsFree
    from util import mutate

    rng = np.random.default_rng(10)
    solver = SegmentSolver(PATCH)
    jobs = []
    for i in range(6):
        n = int(rng.integers(60, 110))
        t = random_dna(rng, n)
        q = mutate(rng, t, 0.06)
        m = len(q)
        if i % 2 == 0:
            jobs.append((q, t, EndsFree(target_begin=n, query_begin=m)))
        else:
            jobs.append((q, t, EndsFree(target_end=n, query_end=m)))
    _check_ef(jobs, PATCH, solver)


def test_seg_ends_free_structural_gaps_bit_identical():
    """Skewed pieces with the longer side free at both ends (the
    segmented engine's structural-gap treatment), both orientations."""
    from wfmash_tpu.align.wfa_np import EndsFree
    from util import mutate

    rng = np.random.default_rng(11)
    solver = SegmentSolver(PATCH, K=512, smax=320, lseg=2048,
                           max_call=32)
    jobs = []
    q0 = random_dna(rng, 700)
    t0 = random_dna(rng, 180) + mutate(rng, q0, 0.03) + random_dna(rng, 180)
    jobs.append((q0, t0, EndsFree(target_begin=360, target_end=360)))
    t1 = random_dna(rng, 600)
    q1 = random_dna(rng, 140) + mutate(rng, t1, 0.03) + random_dna(rng, 140)
    jobs.append((q1, t1, EndsFree(query_begin=280, query_end=280)))
    _check_ef(jobs, PATCH, solver)


def test_seg_deep_tier_midsize_bit_identical():
    """~1.2 kb end-to-end problems on the K=512 tier-3 envelope."""
    from util import mutate

    rng = np.random.default_rng(12)
    solver = SegmentSolver(PATCH, K=512, smax=320, lseg=2048,
                           max_call=32)
    t = random_dna(rng, 1200)
    q = mutate(rng, t, 0.04)
    _check([(q, t)], PATCH, solver)


def test_tiered_cascade_on_failure():
    """A job that exceeds tier-1's score cap must cascade to a deeper
    tier inside TieredSegmentSolver and come back exact."""
    from wfmash_tpu.align.wfa_seg import TieredSegmentSolver
    from util import mutate

    rng = np.random.default_rng(13)
    solver = TieredSegmentSolver(PATCH)
    t = random_dna(rng, 400)
    q = mutate(rng, t, 0.18)          # score ~> 128: beyond tier 1
    got = solver.solve([(q, t)])[0]
    _, ref = wfa_align(q, t, PATCH)
    assert got == ref


def test_seg_truncated_hull_certificates():
    """Boundary-patch jobs whose seed hull exceeds the band must still
    solve when the score certifies the anchor margin — and must REJECT
    when it does not (sound truncation, round-3)."""
    from wfmash_tpu.align.wfa_np import EndsFree
    from util import mutate

    rng = np.random.default_rng(14)
    solver = SegmentSolver(PATCH, K=512, smax=320, lseg=2048,
                           max_call=32)
    # low-divergence big-erode head patch: hull 2300 wide, score < cert
    t0 = random_dna(rng, 1100)
    q0 = (mutate(rng, t0, 0.03) + random_dna(rng, 100))[:1200]
    ef0 = EndsFree(target_begin=1100, query_begin=1200)
    got = solver.solve([(q0, t0, ef0)])[0]
    _, ref = wfa_align(q0, t0, PATCH, ef0)
    assert got == ref
    # very divergent same-shape patch: must reject (score >= cert bound)
    t2 = random_dna(rng, 900)
    q2 = mutate(rng, t2, 0.30)
    ef2 = EndsFree(target_begin=900, query_begin=900)
    assert solver.solve([(q2, t2, ef2)])[0] is None


# (length range, substitution rate) shaped for each tier of
# TieredSegmentSolver; every job is solved by that tier directly
TIER_SHAPES = [((80, 400), 0.03), ((200, 480), 0.08), ((600, 1700), 0.03),
               ((1000, 3800), 0.01), ((300, 900), 0.06)]


@pytest.mark.parametrize("mode", ["end_to_end", "ends_free"])
@pytest.mark.parametrize("tier", range(5))
def test_lax_tier_bit_identical(tier, mode):
    """The plain-JAX solve at each tier's real shape: every certified
    CIGAR equals wfa_np's, and most jobs certify."""
    from wfmash_tpu.align.wfa_np import EndsFree
    from wfmash_tpu.align.wfa_seg import TieredSegmentSolver
    from util import mutate

    solver = TieredSegmentSolver(PATCH, kernel="lax").tiers[tier]
    (lo, hi), sub = TIER_SHAPES[tier]
    rng = np.random.default_rng(40 + tier)
    jobs = []
    for i in range(6):
        t = random_dna(rng, int(rng.integers(lo, hi)))
        if mode == "end_to_end":
            jobs.append((mutate(rng, t, sub), t, None))
        elif i % 2:
            # free begin on both sequences (a head boundary patch)
            q = mutate(rng, t, sub / 3)
            jobs.append((q, t, EndsFree(target_begin=len(t),
                                        query_begin=len(q))))
        else:
            # free end on the target (a tail patch)
            q = mutate(rng, t[:len(t) - 40], sub / 3)
            jobs.append((q, t, EndsFree(target_end=len(t))))
    assert all(solver.accepts(len(q), len(t), ef) for q, t, ef in jobs)
    st: list = []
    got = solver.solve(jobs, status=st)
    for (q, t, ef), ops, s in zip(jobs, got, st):
        if s == "ok":
            assert ops == wfa_align(q, t, PATCH, ef)[1]
    assert sum(s == "ok" for s in st) >= 4, st


def test_default_kernel_by_platform():
    from wfmash_tpu.align import wfa_seg

    assert wfa_seg.default_kernel() == "lax"   # the tests run on the CPU
    assert SegmentSolver(PATCH).kernel == "lax"


@pytest.mark.parametrize("nj,want", [(1, 8), (8, 8), (9, 16), (300, 512),
                                     (5000, 1024)])
def test_call_rows_pad_to_power_of_two(nj, want):
    """A call's row count: the next power of two, at least 8, at most
    max_call — one compiled shape per power of two."""
    assert SegmentSolver(PATCH)._rows(nj) == want


def test_cuda_call_lowers_with_tier_shapes(monkeypatch):
    """The CUDA route's FFI call at a tier's shape: one u8 buffer row per
    problem in; runs (B, maxr) i32, term (B, 16) i32 and the int16
    history scratch (B, 5*smax*K) out; penalties and shape as
    attributes. Lowered only — the kernel itself runs on the card."""
    import jax
    import jax.numpy as jnp

    from wfmash_tpu.align import wfa_seg

    monkeypatch.setattr(wfa_seg, "_register_cuda_target", lambda: None)
    tier = wfa_seg.TieredSegmentSolver(PATCH, kernel="cuda").t2
    B, L = 8, tier.lseg
    buf = jax.ShapeDtypeStruct((B, L + 64), jnp.uint8)
    fn = jax.jit(lambda b: wfa_seg._seg_cuda(
        b, penalties=PATCH, K=tier.K, smax=tier.smax, maxr=tier.maxr))
    text = fn.lower(buf).as_text()
    assert "wfmash_seg_wfa" in text
    assert f"tensor<{B}x{tier.maxr}xi32>" in text
    assert f"tensor<{B}x16xi32>" in text
    assert f"tensor<{B}x{5 * tier.smax * tier.K}xi16>" in text
    for attr in ("K = %d" % tier.K, "smax = %d" % tier.smax, "o2 = 24"):
        assert attr in text.replace(" : i32", "")


@pytest.mark.gpu
def test_cuda_kernel_matches_lax(gpu):
    """On the card: the CUDA kernel and the plain-JAX solve agree on
    results, statuses and banded CIGARs at every tier."""
    from wfmash_tpu.align.wfa_seg import TieredSegmentSolver
    from util import mutate

    sol = {k: TieredSegmentSolver(PATCH, kernel=k) for k in ("cuda", "lax")}
    rng = np.random.default_rng(77)
    for ti, ((lo, hi), sub) in enumerate(TIER_SHAPES):
        jobs = []
        for _ in range(32):
            t = random_dna(rng, int(rng.integers(lo, hi)))
            jobs.append((mutate(rng, t, sub), t, None))
        out = {}
        for k, s in sol.items():
            st: list = []
            unc: list = []
            got = s.tiers[ti].solve(jobs, status=st, uncertified=unc)
            out[k] = (got, st, unc)
        assert out["cuda"] == out["lax"]
