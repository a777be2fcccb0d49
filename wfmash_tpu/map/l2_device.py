"""Device-side L2 mapping stage: the sliding-sketch walk as batched XLA.

The reference's L2 (reference: src/map/include/mappingCore.hpp:306-442
with SlideMapper, slidingMap.hpp:27-212) walks each L1 candidate's
minmer records through a min-heap window, maintaining the bottom-s union
sketch and tracking argmax runs of the shared-sketch count. Sequential
on CPU; here the whole walk becomes three matrix products per batch of
candidates (production window_len == 0 path, i.e. w-length fragments):

* events of a candidate = its minmer records in (seq, wpos) order
  (lead-ins whose interval covers range_start included). Record j is
  ACTIVE at event i iff j <= i (already inserted) and
  wpos_end[j] > wpos[i] (not yet evicted) — the closed form of the
  heap eviction, exact because window_len == 0 evicts every expired
  record before each insertion;
* pair(i, j) = that predicate as a (E, E) 0/1 matrix; per-slot counts
  cnt/nb/votes at every event are pair @ onehot(slot) products (bf16
  inputs that are 0 or +-1, f32 accumulation — exact for counts < 2^24
  at any matmul precision);
* SlideMapper's pivot: rank(l) = (l+1) + cum(nb) is strictly
  increasing, so slot l is inside the bottom-s union sketch iff
  rank(l) <= s. shared(i) / votes(i) are masked row sums. Ref hashes
  above the largest query hash are dropped (slidingMap.hpp insert
  returns early) via a dead slot S.

The argmax-run emission (best runs, prev-event strand votes, join
within one window — mappingCore.hpp:402-435) is replayed on host from
the device-computed shared/votes arrays. Bit-identical to
compute_l2_mapped_regions (tested against it and the C++ native walk).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .l1l2 import L2Mapping, _lower_bound_records
from ..params import STRAND_FWD, STRAND_REV


@partial(jax.jit, static_argnames=("S",))
def _l2_walk_kernel(wpos, wend, slot, svote, valid, s_row, *, S):
    """(B, E) event arrays -> (shared (B, E), votes (B, E)) int32.

    slot: searchsorted position into the row's query sketch, in [0, S]
    (S = ignored/above-max); svote: q_strand*ref_strand for eq events,
    else 0; eq-ness is encoded as svote != 0 ... NO: votes can be 0 for
    ambiguous strands, so eq is passed via slot sign: eq events carry
    slot, non-eq carry slot + (S + 1). Decoded here."""
    B, E = wpos.shape
    eq = slot <= S
    slot_eq = jnp.where(eq, slot, 0)
    slot_nb = jnp.where(eq, 0, slot - (S + 1))
    lane = jnp.arange(E, dtype=jnp.int32)
    tri = lane[None, :] <= lane[:, None]              # j <= i
    cover = wend[:, None, :] > wpos[:, :, None]       # wend_j > wpos_i
    pair = (tri[None, :, :] & cover & valid[:, None, :]).astype(
        jnp.bfloat16)

    def oh(sl, mask):
        m = (sl[:, :, None] == jnp.arange(S + 1)[None, None, :]) \
            & mask[:, :, None]
        return m.astype(jnp.bfloat16)

    oh_eq = oh(slot_eq, eq & valid)
    oh_nb = oh(slot_nb, (~eq) & valid)
    oh_votes = oh_eq * svote[:, :, None].astype(jnp.bfloat16)

    def mm(a):
        return jax.lax.dot_general(
            pair, a, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)

    cnt = mm(oh_eq)[:, :, :S]
    nbx = mm(oh_nb)[:, :, :S]
    votes = mm(oh_votes)[:, :, :S]
    rank = jnp.cumsum(nbx, axis=2) + jnp.arange(
        1, S + 1, dtype=jnp.float32)[None, None, :]
    in_b = rank <= s_row[:, None, None].astype(jnp.float32)
    shared = jnp.sum(jnp.where(in_b, cnt, 0.0), axis=2)
    votes_t = jnp.sum(jnp.where(in_b, votes, 0.0), axis=2)
    return shared.astype(jnp.int32), votes_t.astype(jnp.int32)


class DeviceL2:
    """Batched device walk over L1 candidates. Fixed call shapes
    (BATCH x E_CAP x (S_CAP+1)); rows that overflow fall back to host."""

    # candidates per call: one call's fixed cost is shared by 256 rows
    BATCH = 256
    E_CAP = 768
    S_CAP = 256

    def __init__(self, index, params):
        self.params = params
        self.mi = index.minmer_index
        self.index = index

    def walk(self, rows):
        """rows: list of (sketch, q_len, candidate). Returns per row a
        list[L2Mapping] or None (host fallback: oversized / non-default
        window)."""
        out: list = [None] * len(rows)
        w = self.params.window_length
        prepped = []
        for ri, (sk, q_len, cand) in enumerate(rows):
            if q_len != w or sk.sketch_size > self.S_CAP:
                continue
            ev = self._events(sk, cand)
            if ev is None:
                continue
            prepped.append((ri, sk, cand, ev))
        for c0 in range(0, len(prepped), self.BATCH):
            self._walk_chunk(prepped[c0:c0 + self.BATCH], rows, out)
        return out

    def _events(self, sk, cand):
        mi = self.mi
        w = self.params.window_length
        lo = _lower_bound_records(mi, cand.seq_id,
                                  cand.range_start - w - 1)
        hi = np.searchsorted(mi["seq_id"], cand.seq_id, side="right")
        sl = mi[lo:hi]
        sl = sl[sl["wpos"] <= cand.range_end]
        lead = (sl["wpos"] < cand.range_start) \
            & (sl["wpos_end"] > cand.range_start)
        main = sl["wpos"] >= cand.range_start
        keep = lead | main
        sl = sl[keep]
        if len(sl) > self.E_CAP:
            return None
        is_main = main[keep]
        # slots + eq + votes against the query sketch
        slots = np.searchsorted(sk.hashes, sl["hash"])
        inb = slots < sk.sketch_size
        eq = np.zeros(len(sl), bool)
        eq[inb] = sk.hashes[slots[inb]] == sl["hash"][inb]
        svote = np.zeros(len(sl), np.int32)
        if eq.any():
            svote[eq] = (sk.strand[slots[eq]].astype(np.int32)
                         * sl["strand"][eq].astype(np.int32))
        # ignored events (above the max query hash): dead slot S_CAP
        slots = np.where(inb, slots, self.S_CAP).astype(np.int32)
        # encode eq-ness: non-eq events offset by S_CAP + 1
        slot_code = np.where(eq, slots, slots + self.S_CAP + 1)
        return (sl["wpos"].astype(np.int32),
                sl["wpos_end"].astype(np.int32), slot_code.astype(np.int32),
                svote, is_main)

    def _walk_chunk(self, chunk, rows, out):
        import time

        from ..utils import perf

        B, E, S = self.BATCH, self.E_CAP, self.S_CAP
        wpos = np.zeros((B, E), np.int32)
        wend = np.zeros((B, E), np.int32)
        slot = np.full((B, E), S, np.int32)
        svote = np.zeros((B, E), np.int32)
        valid = np.zeros((B, E), bool)
        s_row = np.ones(B, np.int32)
        for j, (ri, sk, cand, ev) in enumerate(chunk):
            e = len(ev[0])
            wpos[j, :e], wend[j, :e], slot[j, :e], svote[j, :e] = ev[:4]
            valid[j, :e] = True
            s_row[j] = sk.sketch_size
        t0 = time.monotonic()
        shared, votes = _l2_walk_kernel(
            jnp.asarray(wpos), jnp.asarray(wend), jnp.asarray(slot),
            jnp.asarray(svote), jnp.asarray(valid), jnp.asarray(s_row),
            S=S)
        shared = np.asarray(shared)
        votes = np.asarray(votes)
        perf.add("map.device_s", time.monotonic() - t0)
        perf.add("map.l2_device_calls", 1)
        for j, (ri, sk, cand, ev) in enumerate(chunk):
            out[ri] = self._emit(cand, ev, shared[j], votes[j])

    def _emit(self, cand, ev, shared, votes):
        """Replay the argmax-run emission (mappingCore.hpp:402-435 +
        the _close_l2 join) from per-event shared/votes."""
        w = self.params.window_length
        wpos_a, _, _, _, is_main = ev
        n_ev = len(wpos_a)
        mains = np.nonzero(is_main)[0]
        if len(mains) == 0:
            return []
        sh = shared[mains]
        vo = votes[mains]
        wp = wpos_a[mains]
        best = max(int(sh.max()), 1)
        at = sh == best
        if not at.any():
            return []
        # maximal runs of consecutive `at` events
        padded = np.concatenate(([False], at, [False]))
        d = np.diff(padded.astype(np.int8))
        starts = np.nonzero(d == 1)[0]
        ends = np.nonzero(d == -1)[0] - 1        # inclusive
        out: list[L2Mapping] = []
        for a, b in zip(starts, ends):
            # close uses the strand votes as of the run's last event
            sv = int(vo[b])
            cur_start = int(wp[a])
            cur_end = int(wp[b])
            strand = STRAND_FWD if sv >= 0 else STRAND_REV
            if not out or out[-1].optimal_end + w < cur_start:
                out.append(L2Mapping(
                    seq_id=cand.seq_id,
                    mean_optimal_pos=(cur_start + cur_end) // 2,
                    optimal_start=cur_start, optimal_end=cur_end,
                    shared_sketch_size=best, strand=strand))
            else:
                out[-1].optimal_end = cur_end
                out[-1].mean_optimal_pos = (
                    out[-1].optimal_start + out[-1].optimal_end) // 2
        return out
