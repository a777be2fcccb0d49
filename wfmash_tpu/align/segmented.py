"""Anchor-chain segmented alignment — the device form of wflambda.

The reference's hierarchical path (WFlign::wflign_affine_wavefront,
reference: src/common/wflign/src/wflign.cpp:1061-1175) cracks a huge
alignment into 256-base segments under a guide wavefront with lazy
per-segment WFAs. That guide exists because the CPU must avoid touching
segments off the optimal path; on a GPU the economics invert — thousands
of small independent segment WFAs are nearly free (wfa_seg),
while a score-serial whole-block sweep is the bottleneck. So instead of
a guide wavefront we pin the path with an exact-match anchor chain:

1. exact unique k-mer matches (2-bit packed codes, no hashing — matches
   are certain) between the block's query and target;
2. longest-increasing-subsequence chaining (strictly colinear);
3. cuts at anchor midpoints spaced >= seg_target apart — every cut lies
   INSIDE an exact match run, so each segment is aligned end-to-end
   independently and the stitched CIGAR replays exactly;
4. all segments from ALL blocks solve in batched device calls; segments
   the kernel cannot certify (long, divergent, big indels, band-edge)
   escalate to the exact crossing-payload engine.

Divergence from the reference's default (exact biWFA per block) is a
documented fidelity-ledger item: segment CIGARs are exact WFAs between
anchor cuts, so results are replay-exact and near-optimal, but a path
that would stray from the anchor chain can differ from the global
optimum (same trade the reference itself made for years when wflambda
was its default path). WFMASH_TPU_SEGMENTED=0 restores exact biWFA.
"""

from __future__ import annotations

import numpy as np

from .wfa_np import Penalties

# 2-bit base codes; anything else (N etc.) invalidates overlapping k-mers
_B2 = np.full(256, -1, np.int8)
for _b, _c in ((ord("A"), 0), (ord("C"), 1), (ord("G"), 2), (ord("T"), 3)):
    _B2[_b] = _c

ANCHOR_K = 21


def _kmer_codes(seq: np.ndarray, k: int):
    """(L,) u8 -> (codes (L-k+1,) uint64, valid bool mask). Exact 2-bit
    packing (k <= 31): equal codes <=> equal k-mers, no collisions."""
    n = len(seq) - k + 1
    if n <= 0:
        return np.empty(0, np.uint64), np.empty(0, bool)
    b = _B2[seq]
    valid1 = b >= 0
    bu = np.where(valid1, b, 0).astype(np.uint64)
    code = np.zeros(n, np.uint64)
    for j in range(k):
        code = (code << np.uint64(2)) | bu[j:j + n]
    # a k-mer is valid iff all k bases are valid
    cs = np.concatenate(([0], np.cumsum(~valid1)))
    valid = (cs[k:] - cs[:-k]) == 0
    return code, valid


def _unique_positions(codes: np.ndarray, valid: np.ndarray):
    """Positions of k-mers occurring exactly once; returns (codes, pos)
    sorted by code."""
    pos = np.nonzero(valid)[0]
    c = codes[pos]
    # unstable sort is fine: only count-1 codes survive, so the order
    # within equal-code groups never reaches the output (stable radix
    # argsort on u64 costs ~5x an introsort)
    order = np.argsort(c)
    c, pos = c[order], pos[order]
    if len(c) == 0:
        return c, pos
    first = np.concatenate(([True], c[1:] != c[:-1]))
    count = np.diff(np.concatenate((np.nonzero(first)[0], [len(c)])))
    uniq = np.repeat(count == 1, count)
    return c[uniq], pos[uniq]


def _lis_chain(qpos: np.ndarray, tpos: np.ndarray):
    """Longest strictly-increasing chain of (qpos asc, tpos) anchors
    (patience sorting, O(n log n)); returns kept indices. Native C++
    fast path (bit-identical, tested); Python fallback below."""
    n = len(qpos)
    if n == 0:
        return np.empty(0, np.int64)
    order = np.lexsort((tpos, qpos))
    t = tpos[order]
    from ..native import lis_chain_native

    kept = lis_chain_native(t)
    if kept is not None:
        return order[kept]
    tails = []          # smallest tail tpos per chain length
    tails_idx = []
    parent = np.full(n, -1, np.int64)
    import bisect

    for i in range(n):
        j = bisect.bisect_left(tails, t[i])
        if j > 0:
            parent[i] = tails_idx[j - 1]
        if j == len(tails):
            tails.append(t[i])
            tails_idx.append(i)
        else:
            tails[j] = t[i]
            tails_idx[j] = i
    # walk back from the longest chain's last element
    out = []
    i = tails_idx[-1]
    while i >= 0:
        out.append(i)
        i = parent[i]
    out.reverse()
    return order[np.array(out, np.int64)]


def _rare_positions(codes: np.ndarray, valid: np.ndarray, max_occ: int):
    """Positions of k-mers occurring <= max_occ times (code-sorted)."""
    pos = np.nonzero(valid)[0]
    c = codes[pos]
    order = np.argsort(c, kind="stable")
    c, pos = c[order], pos[order]
    if len(c) == 0:
        return c, pos
    first = np.concatenate(([True], c[1:] != c[:-1]))
    count = np.diff(np.concatenate((np.nonzero(first)[0], [len(c)])))
    keep = np.repeat(count <= max_occ, count)
    return c[keep], pos[keep]


def find_anchors(q: np.ndarray, t: np.ndarray, k: int = ANCHOR_K,
                 max_occ: int = 1, max_pairs: int = 200_000):
    """Colinear chain of exact k-mer matches: (qpos, tpos) arrays
    (strictly increasing in both), possibly empty.

    max_occ > 1 admits REPEATED k-mers (up to max_occ occurrences per
    side, cartesian-paired) — the LIS chain then selects the colinear
    subset; needed for repeat-dense loci where unique k-mers are rare.
    """
    from ..native import find_anchors_native

    nat = find_anchors_native(q.tobytes(), t.tobytes(), k, max_occ,
                              max_pairs)
    if nat is not None:
        return nat
    qc, qv = _kmer_codes(q, k)
    tc, tv = _kmer_codes(t, k)
    if max_occ <= 1:
        if len(q) > 16384:
            # density sampling (spec rule, native twin in anchors.cpp):
            # big blocks carry ~1 unique anchor per bp — thousands of
            # times denser than the cut spacing needs; stride-4 query
            # positions quarter the join/sort/LIS cost
            qv = qv & (np.arange(len(qv)) % 4 == 0)
        return _match_chain(qc, qv, tc, tv)
    cq, pq = _rare_positions(qc, qv, max_occ)
    ct, pt = _rare_positions(tc, tv, max_occ)
    if len(cq) == 0 or len(ct) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    tmap: dict = {}
    prev = None
    for c, p in zip(ct.tolist(), pt.tolist()):
        if c != prev:
            tmap[c] = [p]
            prev = c
        else:
            tmap[c].append(p)
    qs, ts = [], []
    for c, p in zip(cq.tolist(), pq.tolist()):
        hits = tmap.get(c)
        if hits:
            for tp in hits:
                qs.append(p)
                ts.append(tp)
            if len(qs) > max_pairs:
                break
    qpos = np.asarray(qs, np.int64)
    tpos = np.asarray(ts, np.int64)
    keep = _lis_chain(qpos, tpos)
    qpos, tpos = qpos[keep], tpos[keep]
    if len(qpos) > 1:
        mono = np.concatenate(([True], np.diff(qpos) > 0))
        qpos, tpos = qpos[mono], tpos[mono]
    return qpos, tpos


def _match_chain(qc, qv, tc, tv):
    cq, pq = _unique_positions(qc, qv)
    ct, pt = _unique_positions(tc, tv)
    ia = np.searchsorted(ct, cq)
    ia = np.clip(ia, 0, max(len(ct) - 1, 0))
    if len(ct) == 0 or len(cq) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    hit = ct[ia] == cq
    qpos, tpos = pq[hit], pt[ia[hit]]
    keep = _lis_chain(qpos, tpos)
    qpos, tpos = qpos[keep], tpos[keep]
    # enforce strict monotonicity on qpos too (LIS is on tpos)
    if len(qpos) > 1:
        mono = np.concatenate(([True], np.diff(qpos) > 0))
        qpos, tpos = qpos[mono], tpos[mono]
    return qpos, tpos


def pick_cuts(qpos: np.ndarray, tpos: np.ndarray, k: int,
              seg_target: int, max_side: int, max_diff: int):
    """Choose cut points (anchor midpoints) so consecutive cuts are
    >= seg_target apart and each resulting segment fits the kernel
    envelope where possible. Returns (qcuts, tcuts) arrays."""
    qc, tc = [], []
    mid = k // 2
    n = len(qpos)
    # both arrays are strictly increasing (LIS + monotonicity filter),
    # so the greedy "skip while below threshold" scan can jump straight
    # to the first admissible anchor with searchsorted — the per-anchor
    # Python loop was the planning phase's hottest spot (~7 s per LPA
    # all-vs-all run)
    last_q = last_t = -(1 << 30)
    i = 0
    while i < n:
        cq_, ct_ = int(qpos[i]) + mid, int(tpos[i]) + mid
        if cq_ - last_q < seg_target or ct_ - last_t < seg_target:
            j1 = np.searchsorted(qpos, last_q + seg_target - mid)
            j2 = np.searchsorted(tpos, last_t + seg_target - mid)
            i = max(int(j1), int(j2), i + 1)
            continue
        qc.append(cq_)
        tc.append(ct_)
        last_q, last_t = cq_, ct_
        i += 1
    return qc, tc


def _solver_accepts(qlen, tlen, lseg, K):
    return (qlen < lseg and tlen < lseg and abs(qlen - tlen) < K // 2 - 1)


def _plan_bounds(q: bytes, t: bytes, seg_target: int, lseg: int, K: int):
    """Anchor-chain planning for one block: k=21 unique anchors, k=13
    rare-kmer retry, one recursive re-anchoring pass for oversize
    inter-anchor spans. Returns (bounds_q, bounds_t) or None when the
    block cannot be segmented (caller falls back to the exact path).
    One native call (anchors.cpp:plan_block, bit-identical — tested)
    with _plan_bounds_py as the spec fallback."""
    from ..native import plan_block_native

    nat = plan_block_native(q, t, seg_target, lseg, K)
    if nat is not NotImplemented:
        return nat
    return _plan_bounds_py(q, t, seg_target, lseg, K)


def _plan_bounds_py(q: bytes, t: bytes, seg_target: int, lseg: int,
                    K: int):
    """Executable spec for plan_block (pure host/numpy — safe in
    fork-pool children; find_anchors itself may use the native core)."""
    qa = np.frombuffer(q, np.uint8)
    ta = np.frombuffer(t, np.uint8)
    half = K // 2 - 8
    # anchor-k ladder: divergent blocks (down to the -p 70 floor) rarely
    # share unique 21-mers, but rare 13-mers still land every ~60 bp;
    # smaller k only ever ADDS cut choices (cuts stay exact matches)
    qc, tc = pick_cuts(*find_anchors(qa, ta, ANCHOR_K), ANCHOR_K,
                       seg_target, lseg - 1, half)
    if len(qc) < max(2, len(q) // (4 * lseg)):
        qc, tc = pick_cuts(*find_anchors(qa, ta, 13, max_occ=4), 13,
                           seg_target, lseg - 1, half)
    if len(qc) < max(2, len(q) // (8 * lseg)):
        # 25-40% divergent regions rarely share rare 13-mers; exact
        # 11-mers still land every ~50 bp there and cuts stay exact
        qc, tc = pick_cuts(*find_anchors(qa, ta, 11, max_occ=8), 11,
                           seg_target, lseg - 1, half)
    if len(qc) < 2:
        return None
    bounds_q = [0] + qc + [len(q)]
    bounds_t = [0] + tc + [len(t)]
    # refine: an inter-anchor span too big for the kernel gets one
    # recursive re-anchoring pass (tighter spacing) — every extra cut
    # keeps the piece off the expensive exact path
    rq, rt = [0], [0]
    for pi in range(len(bounds_q) - 1):
        sq0, sq1 = bounds_q[pi], bounds_q[pi + 1]
        st0, st1 = bounds_t[pi], bounds_t[pi + 1]
        big = not (_solver_accepts(sq1 - sq0, st1 - st0, lseg, K)
                   or sq1 == sq0 or st1 == st0)
        if big and sq1 - sq0 >= 64 and st1 - st0 >= 64:
            sp, tp2 = find_anchors(qa[sq0:sq1], ta[st0:st1], 13, max_occ=4)
            sqc, stc = pick_cuts(sp, tp2, 13, 128, lseg - 1, half)
            if not sqc:
                sp, tp2 = find_anchors(qa[sq0:sq1], ta[st0:st1], 11,
                                       max_occ=8)
                sqc, stc = pick_cuts(sp, tp2, 11, 128, lseg - 1, half)
            rq.extend(c + sq0 for c in sqc)
            rt.extend(c + st0 for c in stc)
        rq.append(sq1)
        rt.append(st1)
    return rq, rt


def segmented_host_align(q: bytes, t: bytes, p, seg_target: int = 256,
                         depth: int = 0):
    """Anchor-cut the block and solve every piece exactly on the native
    host WFA — the capped-score fallback of the budgeted host
    engine (no device involved). Pieces are end-to-end exact; cuts lie
    inside exact k-mer matches, so the stitched CIGAR is replayable and
    near-optimal (same trade as the segmented device default, see
    ARCHITECTURE.md fidelity ledger). Pieces whose score exceeds a
    refinement cap re-anchor once at the full k ladder (divergent
    homology splits into cheap sub-pieces; unanchorable junk gets the
    trivial diagonal alignment). Returns merged (count, op) runs or
    None when the block is unanchorable (caller stays exact)."""
    import os as _os

    from ..native import segmented_solve_native, wfa_align_batch_native
    from .wfa_vec import wfa_align as _wfa

    if depth == 0:
        # one native call for the whole block (plan + placement +
        # pieces + caps + refinement recursion + stitch); this function
        # body remains the executable spec (bit-identical, tested)
        nat = segmented_solve_native(
            q, t, p, seg_target,
            int(_os.environ.get("WFMASH_TPU_REFINE_CAP", "800")))
        if nat is not NotImplemented:
            return nat
    bounds = _plan_bounds(q, t, seg_target, 512, 256)
    if bounds is None:
        return None
    bq, bt = bounds
    out: list = []

    def emit(cnt, op):
        if cnt <= 0:
            return
        if out and out[-1][1] == op:
            out[-1] = (out[-1][0] + cnt, op)
        else:
            out.append((cnt, op))

    plan: list = []      # ('P', piece_idx) | ('G', pre, piece_idx, post)
    #                      | ('I'/'D', count); pre/post are op-run lists
    pieces: list = []
    for i in range(len(bq) - 1):
        sq = q[bq[i]:bq[i + 1]]
        st = t[bt[i]:bt[i + 1]]
        if not sq:
            plan.append(("D", len(st), None, None))
        elif not st:
            plan.append(("I", len(sq), None, None))
            continue
        elif abs(len(sq) - len(st)) > 400:
            # structural gap: an end-to-end WFA pays O(skew) score
            # levels just to emit the gap. Place the SHORT side inside
            # the long one by k-mer diagonal voting, pin the flanks as
            # plain gap runs, align the middle end-to-end — the same
            # (ledgered) treatment as the segmented device path.
            skew = len(sq) - len(st)
            off = (_place_short(st, sq) if skew > 0
                   else _place_short(sq, st))
            if off is None:
                plan.append(("P", len(pieces), None, None))
                pieces.append((sq, st))
            elif skew > 0:
                plan.append(("G", [(off, "I")] if off else [],
                             len(pieces),
                             [(skew - off, "I")] if skew - off else []))
                pieces.append((sq[off:off + len(st)], st))
            else:
                plan.append(("G", [(off, "D")] if off else [],
                             len(pieces),
                             [(-skew - off, "D")] if -skew - off else []))
                pieces.append((sq, st[off:off + len(sq)]))
        else:
            plan.append(("P", len(pieces), None, None))
            pieces.append((sq, st))
    # per-piece caps, two purposes: (a) junk — a piece whose exact
    # score would exceed 55% of its all-mismatch bill (d >~ 0.55:
    # padding flanks, inserted sequence) is not homology; (b) refine —
    # at depth 0 a piece deeper than REFINE_CAP re-anchors at the full
    # k ladder instead of paying O(score^2) whole. Capped pieces that
    # re-anchor solve as sub-pieces; unanchorable ones get the trivial
    # diagonal alignment (ledgered with the segmented junk treatment).
    REFINE_CAP = int(_os.environ.get("WFMASH_TPU_REFINE_CAP", "800"))
    junk = [(p.mismatch * min(len(sq), len(st))) * 55 // 100 + 64
            for sq, st in pieces]
    # REFINE_CAP <= 0 disables the refine cap (junk cap only) — the
    # same convention as the native twin (segsolve.cpp)
    caps = ([min(j, REFINE_CAP) for j in junk]
            if depth == 0 and REFINE_CAP > 0 else junk)
    solved = wfa_align_batch_native(pieces, p, max_scores=caps)
    if solved is None:                       # per-piece fallback
        solved = [_wfa(sq, st, p, None, max_score=c)
                  for (sq, st), c in zip(pieces, caps)]
    fixed = []
    for (s_, ops_), pc in zip(solved, pieces):
        if ops_ is not None:
            fixed.append((s_, ops_))
            continue
        sub = (segmented_host_align(pc[0], pc[1], p, seg_target=128,
                                    depth=1)
               if depth == 0 and min(len(pc[0]), len(pc[1])) >= 96
               else None)
        fixed.append((None, sub if sub is not None else _diag_ops(*pc)))
    solved = fixed
    def emit_runs(runs):
        # bulk append with only the junction run merged (solver output
        # is already RLE-merged internally)
        if not runs:
            return
        i = 0
        if out and out[-1][1] == runs[0][1]:
            out[-1] = (out[-1][0] + runs[0][0], runs[0][1])
            i = 1
        out.extend(runs[i:])

    for ent in plan:
        if ent[0] == "P":
            emit_runs(solved[ent[1]][1])
        elif ent[0] == "G":
            _, pre, pi, post = ent
            emit_runs(pre)
            emit_runs(solved[pi][1])
            emit_runs(post)
        else:
            emit(ent[1], ent[0])
    return out


def _place_short(short: bytes, long_: bytes, k: int = 13,
                 max_occ: int = 8):
    """Best placement offset of `short` inside `long_` by k-mer diagonal
    voting (coarse 32-wide buckets, refined by the median in-bucket
    diagonal). Returns an offset in [0, len(long_) - len(short)] or None
    when fewer than 5 k-mer votes exist (no homology signal)."""
    from ..native import place_short_native

    nat = place_short_native(short, long_, k, max_occ)
    if nat is not NotImplemented:
        return nat
    s = np.frombuffer(short, np.uint8)
    l = np.frombuffer(long_, np.uint8)
    cs, ps = _rare_positions(*_kmer_codes(s, k), max_occ)
    cl, pl = _rare_positions(*_kmer_codes(l, k), max_occ)
    if len(cs) == 0 or len(cl) == 0:
        return None
    # merge-join the code-sorted lists, cartesian within equal runs
    diags = []
    i = j = 0
    while i < len(cs) and j < len(cl) and len(diags) < 100_000:
        if cs[i] < cl[j]:
            i += 1
        elif cs[i] > cl[j]:
            j += 1
        else:
            c = cs[i]
            i2 = i
            while i2 < len(cs) and cs[i2] == c:
                i2 += 1
            j2 = j
            while j2 < len(cl) and cl[j2] == c:
                j2 += 1
            for a in range(i, i2):
                for b in range(j, j2):
                    diags.append(int(pl[b]) - int(ps[a]))
            i, j = i2, j2
    if len(diags) < 5:
        return None
    d = np.asarray(diags)
    lim = len(long_) - len(short)
    d = d[(d >= -32) & (d <= lim + 32)]
    if len(d) < 5:
        return None
    bucket = d // 32
    vals, counts = np.unique(bucket, return_counts=True)
    best = vals[np.argmax(counts)]
    inb = d[bucket == best]
    return int(np.clip(np.median(inb), 0, lim))


def _diag_ops(q: bytes, t: bytes):
    """Trivial replayable alignment: per-base =/X along the main
    diagonal + the length difference as one trailing gap run. Score is
    within x*min(m,n) of optimal by construction; used only for
    junk-level pieces (proven score > the deepest tier budget)."""
    m, n = len(q), len(t)
    L = min(m, n)
    ops: list = []
    if L:
        eq = np.frombuffer(q, np.uint8)[:L] == np.frombuffer(
            t, np.uint8)[:L]
        flip = np.nonzero(np.diff(eq))[0]
        start = 0
        for f in list(flip) + [L - 1]:
            ops.append((int(f) + 1 - start, "=" if eq[start] else "X"))
            start = int(f) + 1
    if m > n:
        ops.append((m - n, "I"))
    elif n > m:
        ops.append((n - m, "D"))
    return ops


def _rev_try_host(rq, st, p, budget):
    """Fork-pool worker: score-bounded rev-comp try (pure numpy)."""
    from .wfa_vec import wfa_align as host_wfa

    _, rops = host_wfa(rq, st, p, max_score=budget)
    return rops


class SegmentedEngine:
    """Engine wrapper: large blocks go anchored+segmented, everything
    else (small blocks, ends-free patch jobs, escalations) delegates to
    the wrapped exact engine. API-compatible with JaxWfaEngine /
    HostWfaEngine (align / align_batch)."""

    def __init__(self, penalties: Penalties, exact_engine,
                 seg_target: int = 256, min_block: int = 600, solver=None):
        from .wfa_seg import TieredSegmentSolver

        self.p = penalties
        self.exact = exact_engine
        self.seg_target = seg_target
        self.min_block = min_block
        self.solver = solver or TieredSegmentSolver(penalties)
        # share the segment solver with the exact engine's leaf batching
        if hasattr(exact_engine, "seg_solver"):
            exact_engine.seg_solver = self.solver
        # under segmentation the exact path only sees leftovers (oversize
        # gaps, unanchorable blocks). The tiers accept everything
        # <= ~2 kb on device, so 2-8 kb leftovers go
        # through the exact sweep recursion (device) whose own leaves
        # land back in the tiers — the host only sees what nothing else
        # can take. WFMASH_TPU_HOST_LEN overrides.
        import os as _os0

        if hasattr(exact_engine, "HOST_LEN"):
            exact_engine.HOST_LEN = int(_os0.environ.get(
                "WFMASH_TPU_HOST_LEN", "1900"))
        self.stats = {"segments": 0, "escalated": 0, "exact_blocks": 0,
                      "inversions": 0, "banded": 0}
        # accept banded (uncertified) piece results for divergent pieces
        # (fidelity-ledger divergence; WFMASH_TPU_EXACT_PIECES=1 forces
        # exact-engine escalation instead, the round-2 behavior)
        import os as _os

        self.banded_pieces = _os.environ.get(
            "WFMASH_TPU_EXACT_PIECES", "0") != "1"
        if hasattr(exact_engine, "banded_leaves"):
            exact_engine.banded_leaves = self.banded_pieces
        self.threads = getattr(exact_engine, "threads", 1)
        self.min_inversion_length = 23   # align_parameters.hpp:70
        # strict-parity mode skips the rev-comp inversion try entirely
        # (the emitting code is dead in the reference binary)
        self.detect_inversions = True
        # per-align_batch inversion records:
        # dict(ji, qa, qb, ta, tb, ops) with block-relative coords
        self.inversions: list = []
        self._host_small_cache: bool | None = None

    def _host_smalls_ok(self) -> bool:
        """Small-job routing: the boundary-patch / escalation jobs run on
        the device tiers unless WFMASH_TPU_SEG_HOST_SMALL=1 sends them
        to one native host call each (bit-identical results — the
        native and device engines share tie-breaks, tested)."""
        if self._host_small_cache is None:
            import os as _os

            from ..native import get_wfa_lib

            self._host_small_cache = (
                _os.environ.get("WFMASH_TPU_SEG_HOST_SMALL") == "1"
                and get_wfa_lib() is not None)
        return self._host_small_cache

    def align(self, query: bytes, target: bytes, ends_free=None):
        return self.align_batch([(query, target, ends_free)])[0]

    def align_batch(self, jobs, bounds=None):
        import time as _time

        from ..utils import perf
        from .cigar import merge_adjacent

        _t0 = _time.monotonic()
        banded0 = self.stats["banded"]
        n = len(jobs)
        plans: list = [None] * n      # per job: list of piece descriptors
        exact_jobs: list = []         # (job_index, piece_index, q, t, ef)
        seg_jobs: list = []           # (job_index, piece_index, q, t, ef)
        placed_jobs: list = []        # (ji, pi, mid_q, mid_t, pre, post)
        whole: set = set()            # ji whose piece 0 IS the whole job
        bounds_of: dict = {}          # ji -> (bounds_q, bounds_t)
        # NOTE: self.inversions accumulates (the driver clears it before
        # each record batch and drains it after — patch-stage align()
        # calls in between must not wipe the mains' records)

        # The device passes run in a BACKGROUND THREAD: tier-1 segment
        # chunks dispatch WHILE the main thread is still planning later
        # blocks (the stream fills as pieces classify), the deeper-tier
        # cascade and placed-middle tiers follow, and the host exact
        # engine overlaps it all — device waits and the native WFA
        # release the GIL, so planning, host tail and device wall
        # overlap instead of alternating.
        import threading as _threading

        def score_ub(sq, st, ef):
            if ef is not None:
                return None          # free spans invalidate the bound
            return (self.p.mismatch * min(len(sq), len(st))
                    + self.p.gap_cost(abs(len(sq) - len(st))))

        stream = (self.solver.stream(certify=True)
                  if hasattr(self.solver, "stream") else None)
        got_m: list = []
        unc_m: list = []
        _dev_err: list = []
        _mids_ready = _threading.Event()

        def _solve_mids():
            if placed_jobs:
                mids = [(q, t) for _, _, q, t, _, _ in placed_jobs]
                got_m[:] = self.solver.solve(
                    mids,
                    max_scores=[
                        self.p.mismatch * min(len(q), len(t))
                        + self.p.gap_cost(abs(len(q) - len(t)))
                        for q, t in mids],
                    uncertified=unc_m)

        def _device_phase():
            try:
                if stream is not None:
                    stream.run()
                else:
                    unc[:] = [None] * len(seg_jobs)
                    seg_stat[:] = [None] * len(seg_jobs)
                    seg_ops[:] = self.solver.solve(
                        [(sq, st, ef) for _, _, sq, st, ef in seg_jobs],
                        max_scores=[score_ub(sq, st, ef)
                                    for _, _, sq, st, ef in seg_jobs],
                        uncertified=unc, status=seg_stat)
                _mids_ready.wait()
                _solve_mids()
            except BaseException as e:  # re-raised on join
                _dev_err.append(e)

        def push_seg(ji, pi, sq, st, ef):
            seg_jobs.append((ji, pi, sq, st, ef))
            if stream is not None:
                stream.add((sq, st, ef), score_ub(sq, st, ef))

        _dev_th = None
        if stream is not None:
            # start consuming before planning produces (stream mode)
            _dev_th = _threading.Thread(target=_device_phase,
                                        name="wfmash-device-phase")
            _dev_th.start()

        # phase 1: small blocks and explicit ends-free jobs (boundary
        # patches) go to the device solver directly when they fit its
        # envelope (or, with WFMASH_TPU_SEG_HOST_SMALL=1, the ends-free
        # jobs to one native host batch — _host_smalls_ok).
        host_small = self._host_smalls_ok()
        host_jobs: list = []          # (ji, pi, q, t, ef)
        todo = []
        for ji, (q, t, ef) in enumerate(jobs):
            q, t = bytes(q), bytes(t)
            if (ef is not None or len(q) < self.min_block
                    or len(t) < self.min_block):
                plans[ji] = None
                whole.add(ji)
                if q and t and ef is not None and host_small:
                    host_jobs.append((ji, 0, q, t, ef))
                elif q and t and self.solver.accepts(len(q), len(t), ef):
                    push_seg(ji, 0, q, t, ef)
                else:
                    if not q or not t:
                        perf.add("align.exact_empty_side", 1)
                    elif ef is not None:
                        perf.add("align.exact_ef_reject", 1)
                        perf.add("align.exact_ef_reject_bp",
                                 max(len(q), len(t)))
                    else:
                        perf.add("align.exact_small_reject", 1)
                    exact_jobs.append((ji, 0, q, t, ef))
                    self.stats["exact_blocks"] += 1
            else:
                todo.append((ji, q, t))
        # phase 2: per-block anchor planning (native C++ host path),
        # fused with piece classification so planned pieces stream to
        # the device thread as they appear. Plans against the CHEAP
        # tier's envelope (512/256): re-anchoring an oversize span into
        # ~256 bp tier-1 segments beats solving it whole on the deep
        # tier; only unanchorable spans should reach t3.
        for (ji, q, t) in todo:
            # NB: must not shadow the align_batch `bounds` parameter —
            # run_host_small reads it after this loop (advisor r4 #1)
            pb = _plan_bounds(q, t, self.seg_target, 512, 256)
            if pb is None:
                plans[ji] = None
                exact_jobs.append((ji, 0, q, t, None))
                self.stats["exact_blocks"] += 1
                continue
            bounds_q, bounds_t = pb
            bounds_of[ji] = (bounds_q, bounds_t)
            pieces = []
            for pi in range(len(bounds_q) - 1):
                sq = q[bounds_q[pi]:bounds_q[pi + 1]]
                st = t[bounds_t[pi]:bounds_t[pi + 1]]
                pieces.append(None)
                if self.solver.accepts(len(sq), len(st)) or not sq or not st:
                    push_seg(ji, pi, sq, st, None)
                else:
                    # a piece with a multi-hundred-bp length skew is a
                    # structural gap: end-to-end WFA would pay O(skew)
                    # score levels just to emit the gap. Free both ends
                    # of the LONGER side instead — the shorter side
                    # aligns locally and the remainder comes out as
                    # leading/trailing gap runs (still consuming both
                    # sequences fully, so stitching stays replay-exact)
                    ef = None
                    skew = len(sq) - len(st)
                    if abs(skew) > 400:
                        from .wfa_np import EndsFree

                        if skew > 0:
                            ef = EndsFree(query_begin=skew, query_end=skew)
                        else:
                            ef = EndsFree(target_begin=-skew,
                                          target_end=-skew)
                    if ef is not None and self.solver.accepts(
                            len(sq), len(st), ef):
                        push_seg(ji, pi, sq, st, ef)
                    elif ef is not None:
                        # too big for the device ends-free envelope: an
                        # unbounded host ends-free WFA on a multi-kb
                        # piece costs seconds (the free spans seed the
                        # whole band). Place the SHORT side inside the
                        # long one by k-mer diagonal voting, emit the
                        # flanks as plain gap runs, and align the middle
                        # end-to-end (device tiers) — near-optimal and
                        # replay-exact (ledgered with the segmented
                        # mode's anchor-pinning divergence).
                        skew = len(sq) - len(st)
                        off = (_place_short(st, sq) if skew > 0
                               else _place_short(sq, st))
                        if off is None:
                            exact_jobs.append((ji, pi, sq, st, ef))
                        elif skew > 0:
                            placed_jobs.append(
                                (ji, pi, sq[off:off + len(st)], st,
                                 [(off, "I")] if off else [],
                                 [(skew - off, "I")] if skew - off
                                 else []))
                        else:
                            placed_jobs.append(
                                (ji, pi, sq, st[off:off + len(sq)],
                                 [(off, "D")] if off else [],
                                 [(-skew - off, "D")] if -skew - off
                                 else []))
                    else:
                        exact_jobs.append((ji, pi, sq, st, ef))
            plans[ji] = pieces

        # planning complete: every device-eligible piece of every block
        # is in the stream (each with its trivial score upper bound —
        # all-mismatch + length-difference gap — so garbage pieces stop
        # sweeping at their bound instead of the tier smax); placed_jobs
        # is final, so release the mids stage too
        self.stats["segments"] += len(seg_jobs)
        perf.add("align.plan_s", _time.monotonic() - _t0)
        _t1 = _time.monotonic()
        unc: list = []
        seg_stat: list = []
        seg_ops: list = []
        if stream is not None:
            stream.close()
        _mids_ready.set()
        if _dev_th is None:   # non-streaming solver: start the thread now
            _dev_th = _threading.Thread(target=_device_phase,
                                        name="wfmash-device-phase")
            _dev_th.start()

        # exact-engine passes. Escalations already failed the segment
        # kernel, so the exact engine must not re-try them there
        # (allow_seg=False); whole-block fallbacks and oversize pieces
        # may still batch their recursion leaves through it.
        def run_exact(batch, allow_seg):
            if not batch:
                return
            try:
                got = self.exact.align_batch(
                    [(q, t, ef) for _, _, q, t, ef in batch],
                    allow_seg=allow_seg)
            except TypeError:      # engines without the keyword
                got = self.exact.align_batch(
                    [(q, t, ef) for _, _, q, t, ef in batch])
            for (ji, pi, _, _, _), ops in zip(batch, got):
                if plans[ji] is None:
                    plans[ji] = [ops]          # whole-block result
                else:
                    plans[ji][pi] = ops

        def run_host_small():
            """One native call for the routed ends-free jobs; per-job
            score bounds (the eroded candidate a patch replaces) prune
            the native wavefronts — a valid bound can never reject, so
            results are unchanged (see wfa.cpp known-bound pruning)."""
            if not host_jobs:
                return
            from ..native import WfaMemoryBudget, wfa_align_batch_native

            pieces = [(q, t) for _, _, q, t, _ in host_jobs]
            spans = [(ef.target_begin, ef.target_end,
                      ef.query_begin, ef.query_end)
                     for *_, ef in host_jobs]
            caps = None
            if bounds is not None:
                caps = [bounds[ji] if ji < len(bounds) else None
                        for ji, *_ in host_jobs]
                if all(c is None for c in caps):
                    caps = None
                else:
                    caps = [-1 if c is None else c for c in caps]
            solved = None
            try:
                solved = wfa_align_batch_native(
                    pieces, self.p, max_scores=caps, ends_free=spans)
            except WfaMemoryBudget:   # pragma: no cover - giant patch
                solved = None
            if solved is None:
                run_exact(host_jobs, True)
                return
            leftovers = []
            for (ji, pi, q, t, ef), (_, ops) in zip(host_jobs, solved):
                if ops is None:       # pragma: no cover - native refusal
                    leftovers.append((ji, pi, q, t, ef))
                elif plans[ji] is None:
                    plans[ji] = [ops]
                else:
                    plans[ji][pi] = ops
            run_exact(leftovers, True)

        # host exact pass, concurrent with the device thread
        _t2 = _time.monotonic()
        try:
            run_host_small()
            run_exact(exact_jobs, True)
        finally:
            _exact_s = _time.monotonic() - _t2
            _dev_th.join()
        if _dev_err:
            raise _dev_err[0]
        if stream is not None:
            seg_ops[:] = stream.res
            seg_stat[:] = stream.st
            unc[:] = stream.unc
        perf.add("align.seg_solve_s", _time.monotonic() - _t1)
        self._escal_census = {}
        for k, ops in enumerate(seg_ops):
            if ops is None and (unc[k] is None or not self.banded_pieces):
                s = seg_stat[k]
                code = s[0] if isinstance(s, tuple) else s
                j = seg_jobs[k]
                sz = 1 << max(6, (max(len(j[2]), len(j[3])) - 1)
                              .bit_length())
                key = (code, sz, j[4] is not None)
                self._escal_census[key] = self._escal_census.get(
                    key, 0) + 1
        escal_jobs = []
        for k, ((ji, pi, sq, st, ef), ops) in enumerate(
                zip(seg_jobs, seg_ops)):
            if ops is None and unc[k] is not None and self.banded_pieces:
                # band-edge contact above the certificate on a divergent
                # piece: the banded CIGAR is replayable and score-valid,
                # just not provably optimal. Accept it ONLY when the
                # score is within 3x the certificate bound — far above
                # it means the true path left the band entirely (repeat
                # diagonal shifts produce garbage all-indel in-band
                # paths); those escalate to the exact engine. Same trade
                # wfmash's historical wflambda + WFmash pruning made;
                # WFMASH_TPU_EXACT_PIECES=1 forces exact escalation.
                u_ops, u_score, u_cert = unc[k]
                if u_score < 3 * max(u_cert, 1):
                    ops = u_ops
                    self.stats["banded"] += 1
            if (ops is None and self.banded_pieces and ef is None
                    and max(len(sq), len(st)) <= 2047):
                s = seg_stat[k]
                if (s[0] if isinstance(s, tuple) else s) == "scorecap":
                    # junk-level piece: every banded sweep ran out of
                    # score budget without finding a path within the
                    # trivial all-mismatch bound — exact alignment of
                    # near-random sequence would buy a few percent of
                    # score for seconds of host time. Emit the diagonal
                    # path instead (replayable; ledgered with the
                    # banded-piece divergence).
                    ops = _diag_ops(sq, st)
                    self.stats["banded"] += 1
            if ops is None:
                escal_jobs.append((ji, pi, sq, st, ef))
                self.stats["escalated"] += 1
            elif plans[ji] is None:
                plans[ji] = [ops]              # whole-block device result
            else:
                plans[ji][pi] = ops

        # placed structural-gap middles (device results from the
        # background thread): accept banded, host-solve failures, wrap
        # with the flank gap runs; tier failures solve the MIDDLE on
        # the host (bounded — never the ends-free monster)
        if placed_jobs:
            mids = [(q, t) for _, _, q, t, _, _ in placed_jobs]
            if self.banded_pieces:
                for k in range(len(got_m)):
                    if got_m[k] is None and unc_m[k] is not None:
                        u_ops, u_score, u_cert = unc_m[k]
                        if u_score < 3 * max(u_cert, 1):
                            got_m[k] = u_ops
                            self.stats["banded"] += 1
            host_mid = [k for k, o in enumerate(got_m) if o is None]
            if host_mid:
                try:
                    got_h = self.exact.align_batch(
                        [(mids[k][0], mids[k][1], None)
                         for k in host_mid], allow_seg=False)
                except TypeError:
                    got_h = self.exact.align_batch(
                        [(mids[k][0], mids[k][1], None)
                         for k in host_mid])
                for k, o in zip(host_mid, got_h):
                    got_m[k] = o
            for (ji, pi, q, t, pre, post), ops in zip(placed_jobs, got_m):
                wrapped = merge_adjacent(pre, list(ops)) if pre else \
                    list(ops)
                wrapped = merge_adjacent(wrapped, post) if post else \
                    wrapped
                plans[ji][pi] = wrapped

        _t2 = _time.monotonic()
        rest = escal_jobs
        if host_small and escal_jobs:
            # tier failures are end-to-end pieces with a trivial valid
            # bound (all-mismatch + skew gap): one capped native call
            # beats per-piece exact sweeps
            from ..native import WfaMemoryBudget, wfa_align_batch_native

            # routing bit-identity (advisor r4 #2): pieces above the
            # exact engine's HOST_LEN go through run_exact in BOTH
            # SEG_HOST_SMALL configs — a native end-to-end solve here
            # could differ byte-wise from the exact engine's crossing-
            # payload split recursion on the same (score-equal) piece.
            hl = int(getattr(self.exact, "HOST_LEN", 1900))

            def _nat_ok(e):
                return e[4] is None and max(len(e[2]), len(e[3])) <= hl

            nat = [e for e in escal_jobs if _nat_ok(e)]
            rest = [e for e in escal_jobs if not _nat_ok(e)]
            if nat:
                solved = None
                try:
                    solved = wfa_align_batch_native(
                        [(sq, st) for _, _, sq, st, _ in nat], self.p,
                        max_scores=[score_ub(sq, st, None)
                                    for _, _, sq, st, _ in nat])
                except WfaMemoryBudget:   # pragma: no cover - giant piece
                    solved = None
                if solved is None:
                    rest = escal_jobs
                else:
                    for (ji, pi, sq, st, ef), (_, ops) in zip(nat, solved):
                        if ops is None:   # pragma: no cover
                            rest.append((ji, pi, sq, st, ef))
                        elif plans[ji] is None:
                            plans[ji] = [ops]
                        else:
                            plans[ji][pi] = ops
        run_exact(rest, False)
        perf.add("align.exact_s",
                 _exact_s + (_time.monotonic() - _t2))
        _t3 = _time.monotonic()
        # patch-region inversion try (wflign_patch.cpp:405-538): every
        # divergent piece — escalated segments and oversize inter-anchor
        # gaps — gets a reverse-complement attempt with a 0.9x score
        # budget; completions are recorded for extra iv:Z:true PAF rows
        if self.detect_inversions:
            # candidate pieces for the rev-comp try: anything DIVERGENT —
            # forward score >= 25% of a per-base mismatch bill (an
            # inverted region scores ~75% mismatches forward). Score-
            # based, not routing-based: round-3's deeper tiers solve many
            # divergent pieces forward on device, so "escalated" alone
            # no longer identifies them (round-2 behavior preserved).
            from .wfa_np import score_cigar as _sc

            div_cands = list(escal_jobs)
            seen = {(e[0], e[1]) for e in escal_jobs}
            for (ji, pi, sq, st, ef) in (seg_jobs + exact_jobs):
                if (ji, pi) in seen or ji not in bounds_of or ef is not None:
                    continue
                pieces = plans[ji]
                ops = pieces[pi] if pieces is not None else None
                if ops is None:
                    continue
                # candidate bar: forward score >= a quarter of the
                # all-mismatch bill. An inverted region's cheapest
                # forward treatment is skipping it with two gap runs
                # (~2*gap_cost(len) ~ 2 per base with e2=1), so the bar
                # must sit below that, not near the mismatch bill.
                bill = self.p.mismatch * min(len(sq), len(st))
                if 4 * _sc(ops, self.p) >= bill:
                    div_cands.append((ji, pi, sq, st, ef))
            self._detect_inversions(
                plans, bounds_of,
                [e for e in div_cands if e[0] in bounds_of])
        perf.add("align.inversion_s", _time.monotonic() - _t3)
        perf.add("align.segments", len(seg_jobs))
        perf.add("align.escalated", len(escal_jobs))
        perf.add("align.exact_blocks", len(exact_jobs))
        perf.add("align.banded", self.stats["banded"] - banded0)
        if n >= 16:
            import sys

            print(f"[wfmash::align] segmented batch: {n} blocks -> "
                  f"{len(seg_jobs)} segments, {len(escal_jobs)} escalated, "
                  f"{len(exact_jobs)} exact-path jobs, "
                  f"{self.stats['banded']} banded; escal census: "
                  f"{sorted(self._escal_census.items())}", file=sys.stderr)

        results = []
        for ji in range(n):
            pieces = plans[ji]
            if pieces is None or any(p is None for p in pieces):
                import sys as _sys

                holes = ([] if pieces is None else
                         [pi for pi, p in enumerate(pieces) if p is None])
                print(f"[wfmash::align] WARNING: block {ji} "
                      f"(q={len(jobs[ji][0])} t={len(jobs[ji][1])}) "
                      f"unresolved: plan={'none' if pieces is None else len(pieces)} "
                      f"holes={holes[:8]}", file=_sys.stderr)
                results.append(None)
                continue
            ops: list = []
            for p in pieces:
                ops = merge_adjacent(ops, p) if ops else list(p)
            results.append(ops)
        return results

    def _detect_inversions(self, plans, bounds_of, candidates):
        """Reverse-complement try on divergent pieces (reference:
        wflign_patch.cpp:405-538 — the forward alignment stays in the
        main CIGAR; a rev-comp alignment that completes within
        ceil(0.9 * fwd_score) steps is recorded for a separate
        pt:Z:true iv:Z:true PAF row)."""
        import math

        from ..sketch.kmers import reverse_complement
        from .wfa_np import score_cigar

        mil = self.min_inversion_length
        cands = []
        for (ji, pi, sq, st, _ef) in candidates:
            if (_ef is not None or len(sq) < mil or len(st) < mil
                    or plans[ji] is None or plans[ji][pi] is None):
                continue
            cands.append((ji, pi, sq, st))
        if not cands:
            return
        from ..utils import perf

        perf.add("align.inv_candidates", len(cands))
        rev_jobs = [(bytes(reverse_complement(bytearray(sq))), st)
                    for _, _, sq, st in cands]
        # certify=False: a banded rev-comp CIGAR within budget is a real
        # alignment within budget (sound evidence of the inversion);
        # optimality is irrelevant for the try, so no band certificate
        # and no host retry of uncertified results. The 0.9x forward
        # budget rides into the kernel as a per-job score cap
        # (max_scores): garbage rev tries give up AT the budget instead
        # of sweeping every tier to smax, and the resulting "scorecap"
        # PROVES rev_score > budget — no host retry. Host fallback
        # remains only for envelope rejects (fork-pooled, bounded).
        budgets = [int(math.ceil(
            score_cigar(plans[ji][pi], self.p) * 0.9))
            for (ji, pi, _, _) in cands]
        from ..native import get_wfa_lib

        if get_wfa_lib() is not None:
            # One capped native call for ALL tries, wherever the other
            # small jobs run: each try either completes within its budget
            # (exact evidence, recorded below) or is PROVEN over it (the
            # cap rejection). A device pre-screen cannot prune this —
            # banded failures prove nothing about out-of-band paths and
            # banded successes are non-canonical co-optimals — so with a
            # native lib the screen is pure overhead (and emitting the
            # native optimum keeps every routing config byte-identical).
            from ..native import WfaMemoryBudget, wfa_align_batch_native

            solved = None
            try:
                solved = wfa_align_batch_native(rev_jobs, self.p,
                                                max_scores=budgets)
            except WfaMemoryBudget:   # pragma: no cover - giant piece
                solved = None
            if solved is not None:
                for (ji, pi, sq, st), (_, rops), budget in zip(
                        cands, solved, budgets):
                    if rops is None or score_cigar(rops, self.p) > budget:
                        continue
                    bq, bt = bounds_of[ji]
                    self.inversions.append(dict(
                        ji=ji, qa=bq[pi], qb=bq[pi + 1], ta=bt[pi],
                        tb=bt[pi + 1], ops=rops))
                    self.stats["inversions"] += 1
                return
        stat: list = []
        rev_got = self.solver.solve(rev_jobs, certify=False, status=stat,
                                    max_scores=budgets)

        def needs_host(k):
            # ONLY a within-budget result is conclusive. A banded sweep
            # that hits the score cap proves nothing about OUT-OF-BAND
            # rev paths within budget (gap ladders can leave any fixed
            # band for less than these budgets), and a banded CIGAR over
            # budget may shadow an in-band optimum under it — both retry
            # exact-capped, matching the native route's (and the
            # reference's) semantics, wflign_patch.cpp:405-538. (The
            # former shortcut "scorecap proves over-budget" missed 122
            # of 242 LPA inversions.)
            return not (rev_got[k] is not None
                        and score_cigar(rev_got[k], self.p) <= budgets[k])

        fb = [k for k in range(len(rev_got)) if needs_host(k)]
        if fb:
            got = None
            from ..native import WfaMemoryBudget, wfa_align_batch_native

            try:
                solved = wfa_align_batch_native(
                    [rev_jobs[k] for k in fb], self.p,
                    max_scores=[budgets[k] for k in fb])
                if solved is not None:
                    got = [ops for _, ops in solved]
            except WfaMemoryBudget:   # pragma: no cover - giant piece
                got = None
            fb_args = [(rev_jobs[k][0], rev_jobs[k][1], self.p,
                        budgets[k]) for k in fb]
            if got is None and self.threads > 1 and len(fb) >= 8:
                from ..utils.hostpool import get_pool

                pool = get_pool(self.threads)
                if pool is not None:
                    got = pool.starmap(
                        _rev_try_host, fb_args,
                        chunksize=max(1, len(fb) // (4 * self.threads)))
            if got is None:
                got = [_rev_try_host(*a) for a in fb_args]
            for k, rops in zip(fb, got):
                rev_got[k] = rops
        for (ji, pi, sq, st), rops, budget in zip(cands, rev_got, budgets):
            if rops is None:
                continue
            if score_cigar(rops, self.p) > budget:
                continue
            bq, bt = bounds_of[ji]
            self.inversions.append(dict(
                ji=ji, qa=bq[pi], qb=bq[pi + 1], ta=bt[pi],
                tb=bt[pi + 1], ops=rops))
            self.stats["inversions"] += 1
