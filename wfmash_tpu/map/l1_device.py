"""Device-side L1 mapping stage: batched hash join + interval sweep.

XLA re-formulation of the reference's L1 candidate search (reference:
src/map/include/mappingCore.hpp:81-301) for BATCHES of query fragments,
bit-identical to the host implementation (map/l1l2.py + native/l1l2.cpp)
for the production split-mapping path (window_len == 0, the default for
every w-length fragment):

1. **join**: each fragment's sketch hashes binary-search the index's
   sorted unique (hi, lo) u32 hash pairs; posting ranges turn into a
   ragged gather (fixed cap per fragment, overflow -> host fallback);
2. **sort**: endpoints key-sort by (target group run, seq, pos, side)
   — reproducing the per-group subranges the host driver feeds to
   compute_l1_candidate_regions one at a time;
3. **sweep**: segmented cumulative sums give every position-group's
   distinct-hash coverage (open_cum at group end minus close_cum at the
   end of the lead (seq,pos) sub-run — the closed-form of the
   trailing/leading pointer walk, including the reference's
   group-by-position-only and drop-last-group quirks);
4. **two thresholds**: pass 1's per-subrange best coverage raises the
   minimum-hit bar through the hypergeometric cutoff table; pass 2
   emits runs >= the raised bar (stage2 full-scan semantics) and joins
   candidates within the cluster length.

The mesh version (parallel/mesh.py) shards step 1-4 over target subsets
("shard" axis: the spatial form of the reference's serial -b loop,
computeMap.hpp:295-327) and fragments ("data" axis).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

NEG = -(1 << 30)
BIG = 1 << 30


def _split_u64(h: np.ndarray):
    return ((h >> np.uint64(32)).astype(np.uint32),
            (h & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _bsearch_pair(key_hi, key_lo, arr_hi, arr_lo):
    """Batched lower-bound binary search of (key_hi, key_lo) u32 pairs in
    the sorted pair arrays (arr_hi, arr_lo). Returns int32 indices."""
    n = arr_hi.shape[0]
    lo = jnp.zeros(key_hi.shape, jnp.int32)
    hi = jnp.full(key_hi.shape, n, jnp.int32)
    steps = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        mh = arr_hi[jnp.clip(mid, 0, n - 1)]
        ml = arr_lo[jnp.clip(mid, 0, n - 1)]
        less = (mh < key_hi) | ((mh == key_hi) & (ml < key_lo))
        less = less & (mid < n)
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    return lo


def _seg_cumsum(x, seg_start):
    """Per-row cumsum of non-negative x that resets at seg_start.

    The reset works by carrying each segment's base (plain-cumsum value
    just before the segment) forward with a max-scan — valid because the
    plain cumsum of non-negative values is non-decreasing."""
    c = jnp.cumsum(x, axis=1)
    base = jnp.where(seg_start, c - x, 0)
    carried = jax.lax.associative_scan(jnp.maximum, base, axis=1)
    return c - carried


def _join_endpoints(qh_hi, qh_lo, q_nh, uh_hi, uh_lo, offs,
                    ep_pos, ep_seq, ep_side, seq_group,
                    q_group, q_seqid, skip_grp, lower_tri, *, cap: int):
    """Hash join + skip filters: sketch hashes -> padded endpoint arrays
    (pos, seq, side, grp) of shape (B, cap), plus per-fragment overflow.
    Pure XLA; shardable over both the index (hash ranges) and the
    fragment batch."""
    B, S = qh_hi.shape
    U = uh_hi.shape[0]

    idx = _bsearch_pair(qh_hi, qh_lo, uh_hi, uh_lo)
    idx_c = jnp.clip(idx, 0, U - 1)
    present = (uh_hi[idx_c] == qh_hi) & (uh_lo[idx_c] == qh_lo)
    lane_s = jax.lax.broadcasted_iota(jnp.int32, (B, S), 1)
    present = present & (lane_s < q_nh[:, None])
    starts = jnp.where(present, offs[idx_c], 0)
    ends = jnp.where(present, offs[idx_c + 1], 0)
    lens = ends - starts
    cum = jnp.cumsum(lens, axis=1)
    total = cum[:, -1]
    overflow = total > cap
    # ragged gather: for out slot j, find which hash range it falls in
    lane_c = jax.lax.broadcasted_iota(jnp.int32, (B, cap), 1)
    # src_hash[j] = first s with cum[s] > j
    src = jnp.sum((cum[:, None, :] <= lane_c[:, :, None]).astype(jnp.int32),
                  axis=2)
    src_c = jnp.clip(src, 0, S - 1)
    base = jnp.where(src_c > 0,
                     jnp.take_along_axis(cum, jnp.maximum(src_c - 1, 0),
                                         axis=1), 0)
    within = lane_c - base
    ep_idx = jnp.take_along_axis(starts, src_c, axis=1) + within
    valid = lane_c < jnp.minimum(total, cap)[:, None]
    ep_idx = jnp.clip(ep_idx, 0, ep_pos.shape[0] - 1)
    pos = jnp.where(valid, ep_pos[ep_idx], BIG)
    seq = jnp.where(valid, ep_seq[ep_idx], BIG)
    side = jnp.where(valid, ep_side[ep_idx].astype(jnp.int32), 0)

    # ---- filters (mappingCore.hpp:109-118) ----------------------------
    grp = jnp.where(valid, seq_group[jnp.clip(seq, 0, None)], BIG)
    skip = jnp.zeros((B, cap), bool)
    skip |= skip_grp[:, None] & (grp == q_group[:, None])
    skip |= lower_tri[:, None] & (q_seqid[:, None] <= seq)
    valid = valid & ~skip
    pos = jnp.where(valid, pos, BIG)
    seq = jnp.where(valid, seq, BIG)
    grp = jnp.where(valid, grp, BIG)
    side = jnp.where(valid, side, 0)
    return pos, seq, side, grp, overflow


def _sweep_candidates(pos, seq, side, grp, min_hits, sketch_size,
                      cutoffs, cut_div, cluster_len, *, maxc: int,
                      stage1: bool = True):
    """Sort + interval-stacking sweep + two-threshold candidate emission
    over padded endpoint arrays (B, cap). Returns (cand (B, maxc, 4),
    ncand (B,), run_overflow (B,))."""
    B, cap = pos.shape

    # ---- sort by (group, seq, pos, side) ------------------------------
    grp_s, seq_s, pos_s, side_s = jax.lax.sort(
        (grp, seq, pos, side), dimension=1, num_keys=4)
    valid = seq_s < BIG

    # ---- sweep --------------------------------------------------------
    first = jnp.concatenate(
        [jnp.ones((B, 1), bool),
         (grp_s[:, 1:] != grp_s[:, :-1])], axis=1) & valid
    new_seg = first                       # target-group subrange starts
    opens = jnp.where(valid & (side_s > 0), 1, 0)
    closes = jnp.where(valid & (side_s < 0), 1, 0)
    open_cum = _seg_cumsum(opens, new_seg)
    close_cum = _seg_cumsum(closes, new_seg)

    # position groups (grouped by pos only within a subrange)
    pg_start = jnp.concatenate(
        [jnp.ones((B, 1), bool),
         (pos_s[:, 1:] != pos_s[:, :-1])
         | (grp_s[:, 1:] != grp_s[:, :-1])], axis=1) & valid
    # (seq, pos) sub-runs
    sr_start = jnp.concatenate(
        [jnp.ones((B, 1), bool),
         (pos_s[:, 1:] != pos_s[:, :-1])
         | (seq_s[:, 1:] != seq_s[:, :-1])], axis=1) & valid
    lane = jax.lax.broadcasted_iota(jnp.int32, pos_s.shape, 1)
    # end index of each run: (next run start) - 1 via reverse min-scan
    def run_end(start_mask):
        aft = jnp.where(start_mask, lane, BIG)
        aft = jnp.concatenate([aft[:, 1:], jnp.full((B, 1), BIG)], axis=1)
        aft = jnp.flip(jax.lax.associative_scan(
            jnp.minimum, jnp.flip(aft, axis=1), axis=1), axis=1)
        return jnp.minimum(aft - 1, cap - 1)

    pg_end = run_end(pg_start)            # per event: its pos-group end
    sr_end = run_end(sr_start)            # per event: its sub-run end

    # coverage evaluated at pos-group starts g:
    #   overlap(g) = open_cum[pg_end(g)] - close_cum[sr_end(g)]
    oc_at_pg_end = jnp.take_along_axis(open_cum, pg_end, axis=1)
    cc_at_sr_end = jnp.take_along_axis(close_cum, sr_end, axis=1)
    overlap = jnp.where(pg_start, oc_at_pg_end - cc_at_sr_end, 0)

    # drop-last-group quirk: a pos-group whose end is the subrange's last
    # event is never examined (mappingCore.hpp:216-249 sampling)
    seg_end = run_end(new_seg)            # subrange end per event
    examined = pg_start & (pg_end < seg_end)

    # ---- pass 1: per-subrange best -> raised threshold ----------------
    ov_tag = jnp.where(pg_start & valid, overlap, 0)

    def seg_scan_max(x, seg):
        # segment max via one scan: add a large per-segment offset so
        # values from earlier segments can never win (overlap < 2^20,
        # segment count is the number of target groups, small)
        seg_id = jnp.cumsum(seg.astype(jnp.int32), axis=1)
        shifted = x + seg_id * (1 << 20)
        m = jax.lax.associative_scan(jnp.maximum, shifted, axis=1)
        return m - seg_id * (1 << 20)

    fwd_best = seg_scan_max(ov_tag, new_seg)
    seg_best = jnp.take_along_axis(fwd_best, seg_end, axis=1)  # per event
    bucket = jnp.clip(
        (jnp.minimum(seg_best, sketch_size[:, None]).astype(jnp.float32)
         / cut_div).astype(jnp.int32), 0, cutoffs.shape[0] - 1)
    raised = jnp.maximum(cutoffs[bucket], min_hits[:, None])
    thresh = jnp.where(seg_best >= min_hits[:, None], raised, BIG)
    if not stage1:   # pass 1 disabled: plain minimum-hit threshold
        thresh = jnp.broadcast_to(min_hits[:, None], thresh.shape)

    # ---- pass 2: eligible runs + candidate emission -------------------
    # compact examined groups to the left (stable) for run analysis
    gsel = jnp.where(examined, 0, 1)
    ord_keys = jax.lax.sort((gsel, lane), dimension=1, num_keys=2)[1]
    def g(a):
        return jnp.take_along_axis(a, jnp.clip(ord_keys, 0, cap - 1), axis=1)
    n_exam = jnp.sum(examined.astype(jnp.int32), axis=1)
    lane2 = lane
    gvalid = lane2 < n_exam[:, None]
    g_seq = jnp.where(gvalid, g(seq_s), BIG)
    g_grp = jnp.where(gvalid, g(grp_s), BIG)
    g_pos = jnp.where(gvalid, g(pos_s), BIG)
    g_ov = jnp.where(gvalid, g(overlap), 0)
    g_th = jnp.where(gvalid, g(thresh), BIG)
    g_elig = gvalid & (g_ov >= g_th)

    # run starts among eligible compacted groups
    p_seq = jnp.concatenate([jnp.full((B, 1), -1), g_seq[:, :-1]], axis=1)
    p_elig = jnp.concatenate([jnp.zeros((B, 1), bool), g_elig[:, :-1]],
                             axis=1)
    rstart = g_elig & (~p_elig | (g_seq != p_seq))
    # candidate join (mappingCore.hpp:287-300): also merge a new run into
    # the previous candidate when same seq and start <= prev_end + cluster
    # prev run's end pos: needs run ends; compute runs first
    rid = jnp.cumsum(rstart.astype(jnp.int32), axis=1) - 1
    rid = jnp.where(g_elig, rid, -1)
    nruns = jnp.max(rid, axis=1) + 1

    # per-run reductions via one-hot matmuls (maxc runs max)
    run_oh = (rid[:, :, None] ==
              jnp.arange(maxc)[None, None, :]) & g_elig[:, :, None]
    run_ohf = run_oh.astype(jnp.int32)
    r_start_pos = jnp.min(
        jnp.where(run_oh, g_pos[:, :, None], BIG), axis=1)
    r_end_pos = jnp.max(
        jnp.where(run_oh, g_pos[:, :, None], NEG), axis=1)
    r_inter = jnp.max(jnp.where(run_oh, g_ov[:, :, None], 0), axis=1)
    r_seq = jnp.min(jnp.where(run_oh, g_seq[:, :, None], BIG), axis=1)
    r_valid = jnp.arange(maxc)[None, :] < jnp.minimum(nruns, maxc)[:, None]

    # join within cluster_len (same seq)
    pr_seq = jnp.concatenate([jnp.full((B, 1), -1), r_seq[:, :-1]], axis=1)
    pr_end = jnp.concatenate([jnp.full((B, 1), NEG), r_end_pos[:, :-1]],
                             axis=1)
    # joined when same seq and gap small; chained joins via segment ids
    joined = r_valid & (r_seq == pr_seq) & (
        r_start_pos <= pr_end + cluster_len)
    cstart = r_valid & ~joined
    cid = jnp.cumsum(cstart.astype(jnp.int32), axis=1) - 1
    cid = jnp.where(r_valid, cid, -1)
    ncand = jnp.max(cid, axis=1) + 1
    c_oh = (cid[:, :, None] == jnp.arange(maxc)[None, None, :]) & \
        r_valid[:, :, None]
    c_seq = jnp.min(jnp.where(c_oh, r_seq[:, :, None], BIG), axis=1)
    c_start = jnp.min(jnp.where(c_oh, r_start_pos[:, :, None], BIG), axis=1)
    c_end = jnp.max(jnp.where(c_oh, r_end_pos[:, :, None], NEG), axis=1)
    c_inter = jnp.max(jnp.where(c_oh, r_inter[:, :, None], 0), axis=1)
    cand = jnp.stack([c_seq, c_start, c_end, c_inter], axis=2)
    return cand, jnp.minimum(ncand, maxc), nruns > maxc


@partial(jax.jit,
         static_argnames=("cap", "maxc", "full_scan", "stage1"))
def _l1_kernel(qh_hi, qh_lo, q_nh, uh_hi, uh_lo, offs,
               ep_pos, ep_seq, ep_side, seq_group,
               q_group, q_seqid, skip_grp, lower_tri, min_hits,
               sketch_size, cutoffs, cut_div, cluster_len,
               *, cap: int, maxc: int, full_scan: bool,
               stage1: bool = True):
    """Batched single-device L1 (join + sweep). Shapes:
    qh_hi/qh_lo: (B, S) sketch hashes (pad: 0xFFFFFFFF pairs)
    q_nh: (B,) valid hash counts
    uh_hi/uh_lo: (U,) sorted unique index hashes; offs: (U+1,)
    ep_pos/ep_seq/ep_side: (E,) endpoint SoA (side +1 open / -1 close)
    seq_group: (n_seqs,) group per target seq id
    q_group/q_seqid: (B,) per-fragment query group/seq id
    skip_grp/lower_tri: (B,) bool flags; min_hits: (B,)
    sketch_size: (B,); cutoffs: (T,) int32; cut_div: scalar f32
    Returns (cand (B, maxc, 4) int32 [seq, start, end, inter],
             n_cand (B,), overflow (B,) bool)."""
    pos, seq, side, grp, overflow = _join_endpoints(
        qh_hi, qh_lo, q_nh, uh_hi, uh_lo, offs, ep_pos, ep_seq, ep_side,
        seq_group, q_group, q_seqid, skip_grp, lower_tri, cap=cap)
    cand, ncand, run_over = _sweep_candidates(
        pos, seq, side, grp, min_hits, sketch_size, cutoffs, cut_div,
        cluster_len, maxc=maxc, stage1=stage1)
    return cand, ncand, overflow | run_over


class DeviceL1:
    """Host wrapper: prepares device-resident index arrays from a
    MinmerIndex and runs batched fragment L1 (bit-identical to the host
    path for window_len == 0 + stage2 full-scan; anything else, or a
    fragment overflowing the endpoint cap, reports None for host
    fallback)."""

    def __init__(self, index, group_arr: np.ndarray, params,
                 sketch_cutoffs: np.ndarray, cap: int = 4096,
                 maxc: int = 64):
        self.cap = cap
        self.maxc = maxc
        self.params = params
        uh = index.unique_hashes
        uh_hi, uh_lo = _split_u64(uh.astype(np.uint64))
        ep = index.endpoints
        # device-resident index (uploaded once per target subset; the
        # reference's posting table equivalent, SURVEY §2.4)
        self.uh_hi = jnp.asarray(uh_hi)
        self.uh_lo = jnp.asarray(uh_lo)
        self.offs = jnp.asarray(index.endpoint_offsets.astype(np.int32))
        self.ep_pos = jnp.asarray(ep["pos"].astype(np.int32))
        self.ep_seq = jnp.asarray(ep["seq_id"].astype(np.int32))
        self.ep_side = jnp.asarray(ep["side"].astype(np.int8))
        self.group_arr = jnp.asarray(group_arr.astype(np.int32))
        self.cutoffs = jnp.asarray(np.asarray(sketch_cutoffs, np.int32))
        self.cut_div = np.float32(max(1.0, params.sketch_size / 1000.0))

    # fixed call shapes: fragments are processed in chunks of BATCH rows
    # with the sketch dimension padded to a multiple of 64, so a whole
    # mapping run compiles O(1) programs per target subset instead of one
    # per (batch, sketch-max) combination
    BATCH = 256

    def candidates(self, frags):
        """frags: list of dicts with keys hashes (sorted u64 array),
        n (sketch size), q_len, q_seqid, q_group, min_hits.
        Returns list of (list[tuple(seq,start,end,inter)] | None)."""
        out: list = []
        for c0 in range(0, len(frags), self.BATCH):
            out.extend(self._candidates_chunk(frags[c0:c0 + self.BATCH]))
        return out

    def _candidates_chunk(self, frags):
        import time

        from ..utils import perf

        p = self.params
        if not frags:
            return []
        B = self.BATCH
        S = -(-max(max(len(f["hashes"]) for f in frags), 1) // 64) * 64
        qh = np.full((B, S), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
        q_nh = np.zeros(B, np.int32)
        meta = np.zeros((B, 5), np.int32)
        for i, f in enumerate(frags):
            h = np.asarray(f["hashes"], np.uint64)
            qh[i, :len(h)] = h
            q_nh[i] = len(h)
            meta[i] = (f["q_group"], f["q_seqid"], f["min_hits"],
                       f["n"], f["q_len"])
        meta[len(frags):, 3] = 1          # pad rows: sketch_size >= 1
        t0 = time.monotonic()
        qh_hi, qh_lo = _split_u64(qh)
        cand, ncand, overflow = _l1_kernel(
            jnp.asarray(qh_hi), jnp.asarray(qh_lo), jnp.asarray(q_nh),
            jnp.asarray(self.uh_hi), jnp.asarray(self.uh_lo),
            jnp.asarray(self.offs), jnp.asarray(self.ep_pos),
            jnp.asarray(self.ep_seq), jnp.asarray(self.ep_side),
            jnp.asarray(self.group_arr),
            jnp.asarray(meta[:, 0]), jnp.asarray(meta[:, 1]),
            jnp.asarray(np.full(B, p.skip_self or p.skip_prefix)),
            jnp.asarray(np.full(B, p.lower_triangular)),
            jnp.asarray(meta[:, 2]), jnp.asarray(meta[:, 3]),
            jnp.asarray(self.cutoffs), self.cut_div,
            np.int32(p.window_length),
            cap=self.cap, maxc=self.maxc, full_scan=True,
            stage1=bool(p.stage1_topANI_filter))
        cand = np.asarray(cand)
        ncand = np.asarray(ncand)
        overflow = np.asarray(overflow)
        perf.add("map.device_s", time.monotonic() - t0)
        perf.add("map.device_calls", 1)
        out = []
        for i, f in enumerate(frags):
            # tail fragments (q_len > window) need the windowed
            # hash-dedup branch of the L1 sweep (l1l2.py:144-161,
            # mappingCore.hpp windowLen != 0), which this batched sweep
            # does not implement — those (at most one per query) route
            # to the bit-identical host path, as do overflowed batches
            # and non-full-scan modes.
            if overflow[i] or f["q_len"] != p.window_length \
                    or not p.stage2_full_scan:
                out.append(None)
                continue
            rows = [tuple(int(x) for x in cand[i, j])
                    for j in range(int(ncand[i]))]
            out.append(rows)
        return out
