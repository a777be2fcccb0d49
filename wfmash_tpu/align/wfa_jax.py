"""Batched wavefront alignment in JAX — the exact device engine.

The reference's default aligner is WFA2-lib's biWFA ("MemoryUltralow",
wflign.cpp:136-148): exact gap-affine-2p alignment in O(span) memory. This
module provides a batched device equivalent with a design chosen for exact
provability and lockstep batching:

* **Sweep kernel** (:func:`_advance`): advances the five wavefronts
  (M, I1, I2, D1, D2) one score step for a whole batch, keeping only a
  ring of the last R = max(x, o1+e1, o2+e2)+1 score levels in memory.
  The match-extension compares gathered packed words, EXT_BYTES at a
  time, repeated while any diagonal consumed a full window.

* **Crossing payloads**: each wavefront entry carries the cell at which
  its path crossed a per-problem split boundary (row v == mid for
  target-axis splits, column h == mid for query-axis splits). Crossings
  inside a gap run are anchored at the run's gap-OPEN cell (always an
  M-state boundary), so splitting at the anchor is exactly
  score-preserving: left-optimal + right-optimal == total-optimal.
  This is the Hirschberg construction on wavefronts; unlike biWFA
  breakpoint detection it needs no overlap lemmas, at the cost of
  O(log) sweeps instead of 2.

* **Recursion** (host): each problem is swept once to find its score and
  split anchor, split, and re-queued; problems small enough
  (score x span below the history budget) are leaves: on a GPU they go
  to the segment solver (align/wfa_seg.py) in batches, and what it
  cannot settle to the exact host aligner.

Cross-checked against wfa_np and the O(nm) oracle in tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .wfa_np import EndsFree, Penalties
from .wfa_vec import wfa_align

NEG_I = -(1 << 28)
NEG = jnp.int32(NEG_I)
UNSET = jnp.int32(-1)

# state indices
M_, I1_, I2_, D1_, D2_ = 0, 1, 2, 3, 4


def _host_solve(q, t, ef, p):
    """Fork-pool worker: pure-numpy host WFA (no device access)."""
    _, ops = wfa_align(q, t, p, ef)
    return ops


def _wfa_log(msg: str) -> None:
    import sys

    print(msg, file=sys.stderr)


def ring_size(p: Penalties) -> int:
    return max(
        p.mismatch,
        p.gap_opening1 + p.gap_extension1,
        p.gap_opening2 + p.gap_extension2,
    ) + 1


# ---------------------------------------------------------------------------
# The sweep kernel
# ---------------------------------------------------------------------------
#
# Arrays (B = batch, R = ring, K = diagonal span; diagonal k = d - K//2):
#   off:    (B, R, 5, K) int32   wavefront offsets h (NEG = unset)
#   anc_v:  (B, R, 5, K) int32   crossing anchor v (UNSET = not crossed)
#   anc_h:  (B, R, 5, K) int32   crossing anchor h
#   open_a: (B, R, 4, K) int32   gap-open anchor for I1,I2 (axis coord v)
#                                 and D1,D2 (axis coord... see below)
#
# For I runs, v is constant and h grows: a query-axis crossing (h passes
# mid) is anchored at the gap-open cell (v, open_h); we store open_h.
# For D runs, h is constant and v grows: a target-axis crossing anchored
# at (open_v, h); we store open_v.
# Gap-open slot layout in open_a: [I1 open_h, I2 open_h, D1 open_v, D2 open_v].


def _advance(off, anc_v, anc_h, open_a, s, query_b, target_b, qlen, tlen,
             axis_is_query, mid, K: int, R: int, penalties: Penalties,
             kvec=None):
    """One score step. query_b/target_b are padded word tables from
    :func:`make_blocks`. kvec optionally overrides the lane->diagonal
    map (default: lane i is diagonal i - K//2) — the diagonal-sharded
    multi-chip sweep passes each shard's global diagonal window."""
    p = penalties
    x, o1, e1, o2, e2 = (
        p.mismatch, p.gap_opening1, p.gap_extension1,
        p.gap_opening2, p.gap_extension2,
    )
    B = off.shape[0]
    if kvec is None:
        kvec = (jnp.arange(K, dtype=jnp.int32) - K // 2)[None, :]

    def land(score, state, arr, fill):
        ok = score >= 0
        slot = jnp.maximum(score, 0) % R
        w = arr[:, slot, state, :]
        return jnp.where(ok, w, fill)

    def wf(score, state):
        return land(score, state, off, NEG)

    def pay(score, state):
        return (
            land(score, state, anc_v, UNSET),
            land(score, state, anc_h, UNSET),
        )

    def gap_open_payload(score, gslot):
        ok = score >= 0
        slot = jnp.maximum(score, 0) % R
        w = open_a[:, slot, gslot, :]
        return jnp.where(ok, w, UNSET)

    def sr(a, fill):  # value at k-1
        return jnp.concatenate([jnp.full((B, 1), fill, a.dtype), a[:, :-1]], axis=1)

    def sl(a, fill):  # value at k+1
        return jnp.concatenate([a[:, 1:], jnp.full((B, 1), fill, a.dtype)], axis=1)

    # ---- gap wavefronts ------------------------------------------------
    def gap_wave(open_score, ext_score, ext_state, gslot, is_ins):
        m_src = wf(open_score, M_)
        g_src = wf(ext_score, ext_state)
        mp_v, mp_h = pay(open_score, M_)
        gp_v, gp_h = pay(ext_score, ext_state)
        g_open = gap_open_payload(ext_score, gslot)
        if is_ins:
            m_src_s, g_src_s = sr(m_src, NEG), sr(g_src, NEG)
            mp_v, mp_h = sr(mp_v, UNSET), sr(mp_h, UNSET)
            gp_v, gp_h = sr(gp_v, UNSET), sr(gp_h, UNSET)
            g_open = sr(g_open, UNSET)
        else:
            m_src_s, g_src_s = sl(m_src, NEG), sl(g_src, NEG)
            mp_v, mp_h = sl(mp_v, UNSET), sl(mp_h, UNSET)
            gp_v, gp_h = sl(gp_v, UNSET), sl(gp_h, UNSET)
            g_open = sl(g_open, UNSET)

        use_open = m_src_s >= g_src_s  # tie -> prefer open (documented)
        base = jnp.maximum(m_src_s, g_src_s)
        valid = base > NEG
        new_off = jnp.where(
            valid, base + (1 if is_ins else 0), NEG
        )
        new_pv = jnp.where(use_open, mp_v, gp_v)
        new_ph = jnp.where(use_open, mp_h, gp_h)
        if is_ins:
            # gap-open anchor: h of the M cell (== its offset)
            new_open = jnp.where(use_open, m_src_s, g_open)
        else:
            # gap-open anchor: v of the M cell = offset - (k+1)
            open_v = m_src_s - (kvec + 1)
            new_open = jnp.where(use_open, open_v, g_open)
        new_open = jnp.where(valid, new_open, UNSET)

        # crossing detection inside the gap run
        if is_ins:
            # query-axis crossing: h passes mid during an I step
            crossed_now = (
                axis_is_query[:, None]
                & (new_pv == UNSET)
                & valid
                & (new_off == mid[:, None] + 1)
            )
            # anchor at gap-open cell: (v_run, open_h); v during I run is
            # v = h - k of the OPEN cell = open_h - k_open... the run's v
            # is constant: v = new_off - k_new where k_new = k; compute:
            v_run = new_off - kvec
            # v stays fixed within the run only relative to its own k
            # progression; the open cell is (v_open, open_h) with
            # v_open = open_h - k_open. Since each I step raises both h
            # and k by 1, v_open = new_off - kvec... == v_run.
            new_pv = jnp.where(crossed_now, v_run, new_pv)
            new_ph = jnp.where(crossed_now, new_open, new_ph)
        else:
            # target-axis crossing: v passes mid during a D step
            v_new = new_off - kvec
            crossed_now = (
                (~axis_is_query)[:, None]
                & (new_pv == UNSET)
                & valid
                & (v_new == mid[:, None] + 1)
            )
            new_pv = jnp.where(crossed_now, new_open, new_pv)
            new_ph = jnp.where(crossed_now, new_off, new_ph)
        return new_off, new_pv, new_ph, new_open

    i1, i1pv, i1ph, i1open = gap_wave(s - o1 - e1, s - e1, I1_, 0, True)
    i2, i2pv, i2ph, i2open = gap_wave(s - o2 - e2, s - e2, I2_, 1, True)
    d1, d1pv, d1ph, d1open = gap_wave(s - o1 - e1, s - e1, D1_, 2, False)
    d2, d2pv, d2ph, d2open = gap_wave(s - o2 - e2, s - e2, D2_, 3, False)

    # ---- mismatch ------------------------------------------------------
    mx = wf(s - x, M_)
    mxpv, mxph = pay(s - x, M_)
    mm = jnp.where(mx > NEG, mx + 1, NEG)
    # crossing via the mismatch step
    v_new = mm - kvec
    h_new = mm
    crossed_q = (
        axis_is_query[:, None] & (mxpv == UNSET) & (mm > NEG)
        & (h_new == mid[:, None] + 1)
    )
    crossed_t = (
        (~axis_is_query)[:, None] & (mxpv == UNSET) & (mm > NEG)
        & (v_new == mid[:, None] + 1)
    )
    crossed = crossed_q | crossed_t
    mxpv = jnp.where(crossed, v_new - 1, mxpv)
    mxph = jnp.where(crossed, h_new - 1, mxph)

    # ---- M = max(mm, i1, i2, d1, d2), priority mm > i1 > i2 > d1 > d2 --
    cands = [(mm, mxpv, mxph), (i1, i1pv, i1ph), (i2, i2pv, i2ph),
             (d1, d1pv, d1ph), (d2, d2pv, d2ph)]
    m_off = mm
    m_pv, m_ph = mxpv, mxph
    for c_off, c_pv, c_ph in cands[1:]:
        better = c_off > m_off
        m_off = jnp.where(better, c_off, m_off)
        m_pv = jnp.where(better, c_pv, m_pv)
        m_ph = jnp.where(better, c_ph, m_ph)

    # bounds
    v = m_off - kvec
    ok = (m_off >= 0) & (m_off <= qlen[:, None]) & (v >= 0) & (v <= tlen[:, None])
    m_off = jnp.where(ok, m_off, NEG)
    m_pv = jnp.where(ok, m_pv, UNSET)
    m_ph = jnp.where(ok, m_ph, UNSET)

    # ---- extension with crossing detection -----------------------------
    m_ext = _extend(m_off, kvec, query_b, target_b, qlen, tlen)
    # crossing inside the extension run: boundary coordinate passes mid
    v_pre = m_off - kvec
    v_post = m_ext - kvec
    cross_t = (
        (~axis_is_query)[:, None] & (m_pv == UNSET) & (m_off > NEG)
        & (v_pre <= mid[:, None]) & (v_post > mid[:, None])
    )
    m_pv = jnp.where(cross_t, mid[:, None], m_pv)
    m_ph = jnp.where(cross_t, mid[:, None] + kvec, m_ph)
    cross_q = (
        axis_is_query[:, None] & (m_pv == UNSET) & (m_off > NEG)
        & (m_off <= mid[:, None]) & (m_ext > mid[:, None])
    )
    m_pv = jnp.where(cross_q, mid[:, None] - kvec, m_pv)
    m_ph = jnp.where(cross_q, mid[:, None], m_ph)

    # ---- write ring ----------------------------------------------------
    slot = s % R
    new_off_all = jnp.stack([m_ext, i1, i2, d1, d2], axis=1)
    new_pv_all = jnp.stack([m_pv, i1pv, i2pv, d1pv, d2pv], axis=1)
    new_ph_all = jnp.stack([m_ph, i1ph, i2ph, d1ph, d2ph], axis=1)
    new_open_all = jnp.stack([i1open, i2open, d1open, d2open], axis=1)
    off = off.at[:, slot].set(new_off_all)
    anc_v = anc_v.at[:, slot].set(new_pv_all)
    anc_h = anc_h.at[:, slot].set(new_ph_all)
    open_a = open_a.at[:, slot].set(new_open_all)

    # termination info: M offset on the final diagonal (lane index =
    # k_end - first lane's diagonal; equals k_end + K//2 by default)
    k_end = qlen - tlen
    d_end = jnp.clip(k_end - kvec[0, 0], 0, K - 1)
    final_off = jnp.take_along_axis(m_ext, d_end[:, None], axis=1)[:, 0]
    final_pv = jnp.take_along_axis(m_pv, d_end[:, None], axis=1)[:, 0]
    final_ph = jnp.take_along_axis(m_ph, d_end[:, None], axis=1)[:, 0]
    done = final_off >= qlen
    return off, anc_v, anc_h, open_a, done, final_pv, final_ph


@partial(jax.jit, static_argnames=("K", "R", "penalties"))
def _sweep(off, anc_v, anc_h, open_a, query_w, target_w, qlen, tlen,
           axis_is_query, mid, done0, max_s, K: int, R: int,
           penalties: Penalties):
    """Run the full score loop on device; returns per-problem
    (final_score, anchor_v, anchor_h, converged)."""
    B = off.shape[0]
    query_b = make_blocks(query_w)
    target_b = make_blocks(target_w)

    def cond(carry):
        s, _, _, _, _, finished, _, _, _ = carry
        return (~jnp.all(finished)) & (s < max_s)

    def body(carry):
        s, off, anc_v, anc_h, open_a, finished, f_score, f_pv, f_ph = carry
        s = s + 1
        off, anc_v, anc_h, open_a, done, pv, ph = _advance(
            off, anc_v, anc_h, open_a, s, query_b, target_b, qlen, tlen,
            axis_is_query, mid, K, R, penalties,
        )
        newly = done & ~finished
        f_score = jnp.where(newly, s, f_score)
        f_pv = jnp.where(newly, pv, f_pv)
        f_ph = jnp.where(newly, ph, f_ph)
        finished = finished | done
        return s, off, anc_v, anc_h, open_a, finished, f_score, f_pv, f_ph

    init = (
        jnp.int32(0), off, anc_v, anc_h, open_a, done0,
        jnp.zeros(B, jnp.int32), jnp.full(B, -1, jnp.int32),
        jnp.full(B, -1, jnp.int32),
    )
    s, off, anc_v, anc_h, open_a, finished, f_score, f_pv, f_ph = (
        jax.lax.while_loop(cond, body, init)
    )
    return f_score, f_pv, f_ph, finished


# Extension works on 4-byte words of the padded sequences. Sequences are
# padded with DISTINCT sentinel bytes (query 0x01, target 0x02) so
# out-of-range positions mismatch automatically and no length masks are
# needed. NWORDS fetched words cover (NWORDS-1)*4 bytes per round after
# the per-lane byte-alignment shift.
NWORDS = 17
EXT_BYTES = (NWORDS - 1) * 4


def make_blocks(words):
    """(B, Lw) uint32 -> (B, Lw + NWORDS + 1) uint32: the packed words,
    zero-padded so an extension fetch that starts in range stays in
    range."""
    return jnp.pad(words, ((0, 0), (0, NWORDS + 1)))


def _fetch_aligned_words(words, byte_off, nw: int):
    """nw consecutive u32 words starting at byte byte_off, gathered from
    :func:`make_blocks` output and shifted so byte 0 is byte_off.
    A lane with a negative offset reads zeros. Returns (B, K, nw)
    uint32."""
    B, Lw = words.shape
    word0 = byte_off >> 2
    idx = word0[:, :, None] + jnp.arange(nw + 1, dtype=jnp.int32)
    flat = (jnp.arange(B, dtype=jnp.int32)[:, None, None] * Lw
            + jnp.clip(idx, 0, Lw - 1))
    w = words.reshape(-1)[flat]
    w = jnp.where((word0[:, :, None] >= 0) & (idx < Lw), w, jnp.uint32(0))
    # byte-alignment shift
    r8 = ((byte_off & 3) << 3).astype(jnp.uint32)
    lo_part = w[:, :, :nw] >> r8[:, :, None]
    hi = jnp.where(
        r8[:, :, None] == 0, jnp.uint32(0),
        w[:, :, 1:] << (jnp.uint32(32) - r8)[:, :, None],
    )
    return lo_part | hi


def _extend(m, kvec, query_blocks, target_blocks, qlen, tlen):
    """Advance M offsets while query[h] == target[h - k], comparing
    EXT_BYTES at a time via gathered packed u32 words."""

    def ext_chunk(off):
        h = jnp.where(off > NEG, off, 0)
        v = h - kvec
        v = jnp.where(off > NEG, v, 0)
        qw = _fetch_aligned_words(query_blocks, h, NWORDS - 1)
        tw = _fetch_aligned_words(target_blocks, v, NWORDS - 1)
        x = qw ^ tw
        # per-word leading matched bytes (little-endian: byte 0 first)
        b0 = (x & 0xFF) == 0
        b1 = (x & 0xFF00) == 0
        b2 = (x & 0xFF0000) == 0
        b3 = (x & jnp.uint32(0xFF000000)) == 0
        m0 = b0.astype(jnp.int32)
        m01 = m0 * b1.astype(jnp.int32)
        m012 = m01 * b2.astype(jnp.int32)
        m0123 = m012 * b3.astype(jnp.int32)
        per_word = m0 + m01 + m012 + m0123  # 0..4
        full = (per_word == 4).astype(jnp.int32)
        run_words = jnp.cumprod(full, axis=2)
        # total = 4 * (#fully matched leading words) + partial of next word
        n_full = run_words.sum(axis=2)
        # partial word contribution: per_word at index n_full (0 if all full)
        nw = per_word.shape[2]
        sel = jax.nn.one_hot(jnp.minimum(n_full, nw - 1), nw, dtype=jnp.int32)
        partial = (sel * per_word).sum(axis=2)
        partial = jnp.where(n_full >= nw, 0, partial)
        run = jnp.minimum(n_full * 4 + partial, EXT_BYTES)
        return jnp.where(off > NEG, run, 0)

    def cond(state):
        _, active = state
        return jnp.any(active)

    def body(state):
        cur, active = state
        run = jnp.where(active, ext_chunk(cur), 0)
        new = jnp.where(cur > NEG, cur + run, cur)
        return new, active & (run == EXT_BYTES)

    out, _ = jax.lax.while_loop(cond, body, (m, m > NEG))
    # clamp to true lengths (sentinels guarantee run stops at the boundary,
    # but keep an explicit clamp for safety)
    v = out - kvec
    over = jnp.maximum(
        jnp.maximum(out - qlen[:, None], v - tlen[:, None]), 0
    )
    out = jnp.where(out > NEG, out - over, out)
    return out


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------

@dataclass
class _Sub:
    """A pending subproblem: align query[q0:q1] vs target[t0:t1]."""

    job_id: int
    q0: int
    q1: int
    t0: int
    t1: int
    order: tuple  # position in the output tree (for reassembly)
    force_axis: int = -1  # -1 auto, 0 target-axis, 1 query-axis


class JaxWfaEngine:
    """Batched exact WFA engine (XLA sweeps on the device + host
    recursion)."""

    def __init__(self, penalties: Penalties, batch_size: int = 128,
                 host_len: int = 1500, max_span: int = 4096 + 1):
        self.p = penalties
        self.R = ring_size(penalties)
        self.batch_size = batch_size
        self.HOST_LEN = host_len
        self.HOST_CELLS = 1_000_000   # adaptive leaf: score/2 * span bound
        self.MAX_SPAN = max_span
        # on a GPU, recursion leaves solve on the segment solver
        # (align/wfa_seg.py) in device batches instead of one by one on
        # the host (bit-identical results), and leaves it cannot settle
        # re-enter the sweep recursion
        self.on_gpu = jax.default_backend() == "gpu"
        # installed lazily on a GPU, or injected by SegmentedEngine to
        # share its solver
        self.seg_solver = None
        self.seg_min_batch = 4
        # opt-in (set by SegmentedEngine to its banded_pieces policy):
        # accept banded/diagonal leaf results instead of host WFA for
        # leaves the segment tiers cannot certify. Default False — this
        # engine's standalone contract is exactness.
        self.banded_leaves = False
        # host-leaf pool width (set from -t by make_engine); workers run
        # pure-numpy wfa_align only — no device access
        self.threads = 1

    # -- single-problem API ---------------------------------------------
    def align(self, query: bytes, target: bytes, ends_free: EndsFree | None = None):
        if ends_free is not None or (
            len(query) <= self.HOST_LEN and len(target) <= self.HOST_LEN
        ):
            _, ops = wfa_align(query, target, self.p, ends_free)
            return ops
        return self.align_batch([(query, target, None)])[0]

    def _get_seg_solver(self):
        if self.seg_solver is None and self.on_gpu:
            from .wfa_seg import TieredSegmentSolver

            self.seg_solver = TieredSegmentSolver(self.p)
        return self.seg_solver

    # -- batched API ------------------------------------------------------
    def align_batch(self, jobs, allow_seg: bool = True,
                    bounds=None):
        """jobs: [(query, target, ends_free|None)] -> [ops].

        allow_seg=False skips the segment-kernel leaf batching (used for
        problems that already failed the segment kernel's envelope)."""
        from .cigar import merge_ops

        results: dict[int, dict[tuple, list]] = {}
        self._results = results
        queue: list[_Sub] = []
        deferred: list = []    # (job_id, order, q, t, ef) small problems
        seqs = []
        for i, (q, t, ef) in enumerate(jobs):
            seqs.append((np.frombuffer(bytes(q), dtype=np.uint8),
                         np.frombuffer(bytes(t), dtype=np.uint8)))
            results[i] = {}
            if ef is not None or (
                len(q) <= self.HOST_LEN and len(t) <= self.HOST_LEN
            ):
                deferred.append((i, (), bytes(q), bytes(t), ef))
            else:
                queue.append(_Sub(i, 0, len(q), 0, len(t), ()))

        synth: dict[int, tuple[int, tuple]] = {}

        def drain_queue(queue):
            """Crossing-payload sweep recursion; leaves append to
            `deferred` (closure)."""
            while queue:
                batch = queue[: self.batch_size]
                queue = queue[self.batch_size :]
                # problems with |m - n| beyond the diagonal span budget
                # go straight to the host solver rather than dragging the
                # batch down
                keep = []
                for sub in batch:
                    m_len, n_len = sub.q1 - sub.q0, sub.t1 - sub.t0
                    if 2 * (abs(m_len - n_len) + 16) + 3 > self.MAX_SPAN:
                        q = seqs[sub.job_id][0][sub.q0:sub.q1].tobytes()
                        t = seqs[sub.job_id][1][sub.t0:sub.t1].tobytes()
                        _, ops = wfa_align(q, t, self.p)
                        self._store(sub, ops)
                    else:
                        keep.append(sub)
                batch = keep
                if not batch:
                    continue
                splits = self._sweep_batch(batch, seqs)
                for sub, split in zip(batch, splits):
                    if split is None:
                        continue       # solved directly
                    anchor_v, anchor_h, score = split
                    if anchor_v == 0 and anchor_h == 0:
                        # degenerate anchor — re-sweep the other axis
                        m_len = sub.q1 - sub.q0
                        n_len = sub.t1 - sub.t0
                        cur_axis = 1 if (
                            sub.force_axis == 1
                            or (sub.force_axis == -1 and m_len > n_len)
                        ) else 0
                        queue.append(
                            _Sub(sub.job_id, sub.q0, sub.q1, sub.t0,
                                 sub.t1, sub.order,
                                 force_axis=1 - cur_axis)
                        )
                        continue
                    qm = sub.q0 + anchor_h
                    tm = sub.t0 + anchor_v
                    for side, (a, b, c, d) in enumerate(
                        [(sub.q0, qm, sub.t0, tm), (qm, sub.q1, tm, sub.t1)]
                    ):
                        q_sub = seqs[sub.job_id][0][a:b].tobytes()
                        t_sub = seqs[sub.job_id][1][c:d].tobytes()
                        order = sub.order + (side,)
                        # adaptive leaf rule: defer when score x span is
                        # small enough for the leaf solvers
                        side_len = max(len(q_sub), len(t_sub))
                        est = (score // 2 + 1) * side_len
                        if (side_len <= self.HOST_LEN
                                or est <= self.HOST_CELLS):
                            deferred.append(
                                (sub.job_id, order, q_sub, t_sub, None))
                        else:
                            queue.append(
                                _Sub(sub.job_id, a, b, c, d, order)
                            )

        def seg_pass(entries, seg):
            """Solve deferred entries on the segment tiers; returns the
            unsolved remainder."""
            if seg is None:
                return list(entries)
            solved = [False] * len(entries)
            elig = [k for k, (_, _, q, t, ef) in enumerate(entries)
                    if q and t and seg.accepts(len(q), len(t), ef)]
            if len(elig) >= self.seg_min_batch:
                unc: list = []
                stat: list = []
                got = seg.solve(
                    [(entries[k][2], entries[k][3], entries[k][4])
                     for k in elig], uncertified=unc, status=stat)
                for j, (k, ops) in enumerate(zip(elig, got)):
                    i, order, q, t, ef = entries[k]
                    if ops is None and self.banded_leaves:
                        # same ledgered policy as the segmented engine:
                        # mildly-banded CIGAR (score < 3x certificate),
                        # or the diagonal path for junk-level leaves
                        if unc[j] is not None and \
                                unc[j][1] < 3 * max(unc[j][2], 1):
                            ops = unc[j][0]
                        elif ef is None and max(len(q), len(t)) <= 2047:
                            s = stat[j]
                            code = s[0] if isinstance(s, tuple) else s
                            if code == "scorecap":
                                from .segmented import _diag_ops

                                ops = _diag_ops(q, t)
                    if ops is not None:
                        results[i][order] = ops
                        solved[k] = True
            return [e for k, e in enumerate(entries) if not solved[k]]

        drain_queue(queue)
        seg = self._get_seg_solver() if allow_seg else None
        pending = deferred
        for rnd in range(2):
            unsolved = seg_pass(pending, seg)
            if rnd == 1 or seg is None or not self.on_gpu:
                pending = unsolved
                break
            # leaves the tiers could not settle re-enter the exact sweep
            # recursion as synthetic jobs: the crossing-payload split
            # lands ON the true path, so the halves' bands re-center on
            # the real diagonals (repeat shifts included) and the tiers
            # finish them exactly — the host only sees what nothing else
            # can take.
            requeue, keep = [], []
            for ent in unsolved:
                i, order, q, t, ef = ent
                skew_ok = 2 * (abs(len(q) - len(t)) + 16) + 3 \
                    <= self.MAX_SPAN
                if (ef is None and len(q) >= 600 and len(t) >= 600
                        and max(len(q), len(t)) < 65535 and skew_ok):
                    sid = len(seqs)
                    seqs.append((np.frombuffer(q, dtype=np.uint8),
                                 np.frombuffer(t, dtype=np.uint8)))
                    results[sid] = {}
                    synth[sid] = (i, order)
                    requeue.append(_Sub(sid, 0, len(q), 0, len(t), ()))
                else:
                    keep.append(ent)
            if not requeue:
                pending = keep
                break
            from ..utils import perf as perf_mod

            perf_mod.add("align.resweep_jobs", len(requeue))
            perf_mod.add("align.resweep_kept", len(keep))
            deferred = []
            drain_queue(requeue)
            perf_mod.add("align.resweep_leaves", len(deferred))
            pending = keep + deferred

        rest_entries = pending
        import time as _time

        from ..utils import perf

        _t0 = _time.monotonic()
        n_rest = len(rest_entries)
        import os as _os

        _lg = _os.environ.get("WFMASH_TPU_LEAF_LOG")
        if _lg and rest_entries:
            with open(_lg, "a") as _fh:
                for (_i, _o, q, t, ef) in rest_entries:
                    _fh.write(f"{len(q)}\t{len(t)}\t{ef}\n")
        done_pool = False
        if self.threads > 1 and len(rest_entries) >= 8:
            from ..utils.hostpool import get_pool

            pool = get_pool(self.threads)
            if pool is not None:
                got = pool.starmap(
                    _host_solve,
                    [(q, t, ef, self.p)
                     for (_, _, q, t, ef) in rest_entries],
                    chunksize=max(1, len(rest_entries) //
                                  (4 * self.threads)))
                for (i, order, _, _, _), ops in zip(rest_entries, got):
                    results[i][order] = ops
                done_pool = True
        if not done_pool:
            for (i, order, q, t, ef) in rest_entries:
                _, ops = wfa_align(q, t, self.p, ef)
                results[i][order] = ops
        perf.add("align.host_leaf_s", _time.monotonic() - _t0)
        perf.add("align.host_leaves", n_rest)

        # synthetic sub-jobs assemble back into their parent order slot
        for sid, (pi, porder) in synth.items():
            pieces = results.pop(sid)
            ops = []
            for order in sorted(pieces):
                ops = ops + pieces[order]
            results[pi][porder] = merge_ops(ops)

        out = []
        for i in range(len(jobs)):
            pieces = results[i]
            ops: list = []
            for order in sorted(pieces):
                ops = ops + pieces[order]
            out.append(merge_ops(ops))
        return out

    # -- one batched sweep: score + split anchor ---------------------------
    def _sweep_batch(self, batch: list[_Sub], seqs):
        B = len(batch)
        ms = [s.q1 - s.q0 for s in batch]
        ns = [s.t1 - s.t0 for s in batch]

        def bucket(x):
            # shared pow2 padding with Lq == Lt: every distinct
            # (Lq, Lt, K) combination is a separate XLA/Mosaic compile,
            # so tying the two sides (they differ by < K/2 anyway)
            # halves the shape space across recursion rounds
            return 1 << max(10, (int(x) - 1).bit_length())

        # +EXT_BYTES+8 sentinel padding so extension never needs masks;
        # distinct sentinels guarantee query/target mismatch out of range
        Lq = Lt = bucket(max(max(ms), max(ns)) + EXT_BYTES + 8)
        # adaptive diagonal span: smallest ladder step covering the length
        # difference plus a generous indel-excursion margin (see
        # ARCHITECTURE.md "exactness envelope")
        margin = max(128, max(max(ms), max(ns)) // 16)
        need = 2 * (max(abs(a - b) for a, b in zip(ms, ns)) + margin) + 3
        K = self.MAX_SPAN
        for step in (257, 513, 1025, 2049):
            if need <= step <= self.MAX_SPAN:
                K = step
                break
        R = self.R

        query = np.full((B, Lq), 0x01, dtype=np.uint8)
        target = np.full((B, Lt), 0x02, dtype=np.uint8)
        for i, s in enumerate(batch):
            query[i, : ms[i]] = seqs[s.job_id][0][s.q0 : s.q1]
            target[i, : ns[i]] = seqs[s.job_id][1][s.t0 : s.t1]
        query_w = _pack_words(query)
        target_w = _pack_words(target)

        qlen = np.array(ms, dtype=np.int32)
        tlen = np.array(ns, dtype=np.int32)
        diff = int(np.max(np.abs(qlen - tlen)))
        if 2 * (diff + 16) + 3 > self.MAX_SPAN:
            raise RuntimeError(
                "alignment problem exceeds the diagonal span budget"
            )
        # split the longer axis (or the forced one after a degenerate anchor)
        axis_is_query = qlen > tlen
        for i, sub in enumerate(batch):
            if sub.force_axis == 0:
                axis_is_query[i] = False
            elif sub.force_axis == 1:
                axis_is_query[i] = True
        mid = np.where(axis_is_query, qlen // 2, tlen // 2).astype(np.int32)

        # score-0 seeds: M[k=0] = LCP, with extension-crossing payload
        splits: list = [None] * B
        done0 = np.zeros(B, dtype=bool)
        lcps = np.zeros(B, dtype=np.int32)
        for i in range(B):
            q, t = query[i, : ms[i]], target[i, : ns[i]]
            l = _lcp_np(q, t)
            lcps[i] = l
            if l >= ms[i] and l >= ns[i]:
                splits[i] = None  # perfect match; solved below
                done0[i] = True
                self._emit_trivial(batch[i], l)

        if done0.all():
            return splits

        max_s = int(
            self.p.mismatch * (max(ms) + max(ns))
            + self.p.gap_opening1 + self.p.gap_opening2 + 64
        )
        off = np.full((B, R, 5, K), NEG_I, dtype=np.int32)
        anc_v = np.full((B, R, 5, K), -1, dtype=np.int32)
        anc_h = np.full((B, R, 5, K), -1, dtype=np.int32)
        open_a = np.full((B, R, 4, K), -1, dtype=np.int32)
        for i in range(B):
            off[i, 0, M_, K // 2] = lcps[i]
            if not done0[i] and lcps[i] > mid[i]:
                anc_v[i, 0, M_, K // 2] = mid[i]
                anc_h[i, 0, M_, K // 2] = mid[i]
        from ..utils import perf

        perf.add("align.sweep_calls", 1)
        f_score, f_pv, f_ph, finished = _sweep(
            jnp.asarray(off), jnp.asarray(anc_v), jnp.asarray(anc_h),
            jnp.asarray(open_a), jnp.asarray(query_w),
            jnp.asarray(target_w),
            jnp.asarray(qlen), jnp.asarray(tlen),
            jnp.asarray(axis_is_query), jnp.asarray(mid),
            jnp.asarray(done0), jnp.int32(max_s),
            K=K, R=R, penalties=self.p,
        )
        finished = np.asarray(finished)
        if not finished.all():
            raise RuntimeError("WFA sweep failed to converge")
        f_pv = np.asarray(f_pv)
        f_ph = np.asarray(f_ph)

        for i in range(B):
            if done0[i]:
                continue
            pv, ph = int(f_pv[i]), int(f_ph[i])
            if pv < 0 or ph < 0:
                # path never crossed mid (possible when mid >= n for tiny
                # axes) — fall back to the host aligner
                sub = batch[i]
                q = seqs[sub.job_id][0][sub.q0 : sub.q1].tobytes()
                t = seqs[sub.job_id][1][sub.t0 : sub.t1].tobytes()
                _, ops = wfa_align(q, t, self.p)
                self._store(sub, ops)
                splits[i] = None
            else:
                splits[i] = (pv, ph, int(f_score[i]))
        return splits

    # bookkeeping helpers installed by align_batch
    def _emit_trivial(self, sub: _Sub, match_len: int):
        self._results[sub.job_id][sub.order] = (
            [(match_len, "=")] if match_len else []
        )

    def _store(self, sub: _Sub, ops):
        self._results[sub.job_id][sub.order] = ops


def _pack_words(x: np.ndarray) -> np.ndarray:
    """(B, L) uint8 -> (B, L//4) uint32 little-endian words."""
    B, L = x.shape
    assert L % 4 == 0
    w = x.reshape(B, L // 4, 4).astype(np.uint32)
    return w[:, :, 0] | (w[:, :, 1] << 8) | (w[:, :, 2] << 16) | (w[:, :, 3] << 24)


def _lcp_np(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = a[:n] != b[:n]
    idx = np.nonzero(neq)[0]
    return int(idx[0]) if len(idx) else n
