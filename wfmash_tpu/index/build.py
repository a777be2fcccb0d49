"""Target minmer index: build + frequency filter.

Equivalent of skch::Sketch (reference: src/map/include/winSketch.hpp:63-457):

* per target sequence (>= windowLength bases; shorter are skipped with a
  warning) extract windowed minmer interval records (sketch/winnow);
* count per-hash record frequencies and drop hashes occurring more than
  ``count_threshold`` times, where count_threshold =
  clamp(total_windows * max_kmer_freq, min=10) for fractional -F or the
  literal count for -F > 1 (winSketch.hpp:299-311), with the auto-relax to
  the 99.9th-percentile frequency when more than 50% of window positions or
  70% of unique hashes would be dropped (winSketch.hpp:313-349);
* build two structures:
  - ``minmer_index``: all surviving records sorted by (seq_id, wpos) — the
    L2 stage walks this;
  - a posting table of interval endpoints per hash for the L1 stage: for
    each hash, OPEN points at wpos and CLOSE points at wpos_end, with
    adjacent same-hash intervals coalesced (winSketch.hpp:379-387).

Instead of a hash map, the accelerator-friendly layout is a sorted array join:
``unique_hashes`` (ascending) + CSR offsets into a flat, per-hash
(seq_id, pos, side)-sorted endpoint array. Query lookups become
vectorized ``searchsorted`` joins (device- and host-friendly).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from ..params import MapParams
from ..sketch.winnow import RECORD_DTYPE, winnow_minmers

SIDE_OPEN = np.int8(1)
SIDE_CLOSE = np.int8(-1)

# Endpoint table dtype: one row per interval endpoint.
ENDPOINT_DTYPE = np.dtype(
    [
        ("pos", np.int64),
        ("hash", np.uint64),
        ("seq_id", np.int32),
        ("side", np.int8),
    ]
)


@dataclass
class MinmerIndex:
    """Device-ready CSR posting table + position-sorted record list."""

    minmer_index: np.ndarray          # RECORD_DTYPE, sorted by (seq_id, wpos)
    unique_hashes: np.ndarray         # uint64, ascending
    endpoint_offsets: np.ndarray      # int64, len = len(unique_hashes) + 1
    endpoints: np.ndarray             # ENDPOINT_DTYPE, grouped by hash
    hg_numerator: float = 1.0
    count_threshold: int = 0
    total_windows: int = 0
    filtered_windows: int = 0

    _soa_cache = None

    def soa(self):
        """Contiguous column arrays of minmer_index for the native L2
        walker (hash, wpos, wpos_end, seq_id, strand)."""
        if self._soa_cache is None:
            mi = self.minmer_index
            object.__setattr__(self, "_soa_cache", (
                np.ascontiguousarray(mi["hash"], np.uint64),
                np.ascontiguousarray(mi["wpos"], np.int64),
                np.ascontiguousarray(mi["wpos_end"], np.int64),
                np.ascontiguousarray(mi["seq_id"], np.int32),
                np.ascontiguousarray(mi["strand"], np.int8),
            ))
        return self._soa_cache

    _ep_soa_cache = None

    def endpoints_soa(self):
        """Contiguous column arrays of endpoints for the native
        per-fragment L1 stage (pos, hash, seq_id, side)."""
        if self._ep_soa_cache is None:
            ep = self.endpoints
            object.__setattr__(self, "_ep_soa_cache", (
                np.ascontiguousarray(ep["pos"], np.int64),
                np.ascontiguousarray(ep["hash"], np.uint64),
                np.ascontiguousarray(ep["seq_id"], np.int32),
                np.ascontiguousarray(ep["side"], np.int8),
            ))
        return self._ep_soa_cache

    def lookup(self, hashes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """For each query hash return (start, end) ranges into endpoints
        (empty range when the hash is absent)."""
        idx = np.searchsorted(self.unique_hashes, hashes)
        idx_c = np.minimum(idx, len(self.unique_hashes) - 1)
        present = (len(self.unique_hashes) > 0) & (
            self.unique_hashes[idx_c] == hashes
        )
        starts = np.where(present, self.endpoint_offsets[idx_c], 0)
        ends = np.where(present, self.endpoint_offsets[idx_c + 1], 0)
        return starts, ends


def build_index(
    params: MapParams,
    sequences,  # iterable of (seq_id, seq_bytes)
    log=lambda msg: print(msg, file=sys.stderr),
) -> MinmerIndex:
    """Build the minmer index for one target subset."""
    from ..native import winnow_minmers_native

    all_records = []
    skipped = 0
    total_bp = 0
    for seq_id, seq in sequences:
        if len(seq) < params.window_length:
            skipped += 1
            continue
        total_bp += len(seq)
        if params.use_streaming_minhash and params.sketch_size > 0:
            # experimental whole-sequence MinHash ref sketch
            # (winSketch.hpp:472-483)
            from ..sketch.winnow import sketch_sequence_streaming

            recs = sketch_sequence_streaming(
                seq, params.kmer_size, params.sketch_size,
                params.window_length, seq_id)
        else:
            recs = winnow_minmers_native(
                seq, params.kmer_size, params.window_length,
                params.sketch_size, seq_id=seq_id,
            )
            if recs is None:  # native lib unavailable
                recs = winnow_minmers(
                    seq, params.kmer_size, params.window_length,
                    params.sketch_size, seq_id=seq_id,
                )
        all_records.append(recs)

    if not all_records:
        raise ValueError(
            "reference sketch is empty — sequences shorter than the window "
            "size are not indexed"
        )
    records = np.concatenate(all_records)
    total_windows = len(records)

    # ---- frequency filter (winSketch.hpp:266-349) -------------------------
    uniq, counts = np.unique(records["hash"], return_counts=True)
    min_occ = 10
    if params.max_kmer_freq <= 1.0:
        count_threshold = max(min_occ, int(total_windows * params.max_kmer_freq))
    else:
        count_threshold = max(min_occ, int(params.max_kmer_freq))

    drop = (counts > count_threshold) & (counts > min_occ)
    would_filter_positions = int(counts[drop].sum())
    would_filter_unique = int(drop.sum())
    if (
        would_filter_positions > total_windows // 2
        or would_filter_unique > len(uniq) * 0.7
    ):
        sorted_freqs = np.sort(counts)
        keep_index = min(int(len(sorted_freqs) * 0.999), len(sorted_freqs) - 1)
        new_threshold = max(count_threshold, int(sorted_freqs[keep_index]))
        log(
            f"[wfmash::mashmap] WARNING: Adjusted k-mer frequency threshold "
            f"from {count_threshold} to {new_threshold} to prevent "
            f"over-filtering ({would_filter_positions}/{total_windows} "
            f"positions, {would_filter_unique}/{len(uniq)} unique k-mers)"
        )
        count_threshold = new_threshold
        drop = (counts > count_threshold) & (counts > min_occ)

    # map each record to its hash's count
    rec_count = counts[np.searchsorted(uniq, records["hash"])]
    keep_mask = ~((rec_count > count_threshold) & (rec_count > min_occ))
    filtered = int((~keep_mask).sum())
    records = records[keep_mask]

    # ---- L2 record list: sort by (seq_id, wpos) ----------------------------
    order = np.lexsort((records["wpos"], records["seq_id"]))
    minmer_index = records[order]

    # ---- L1 endpoint posting table ----------------------------------------
    endpoints = _build_endpoints(records)
    uh, eoff = _csr_by_hash(endpoints)

    log(
        f"[wfmash::mashmap] Processed {len(all_records)} sequences "
        f"({skipped} skipped, {total_bp} total bp), {len(uh)} unique hashes, "
        f"{len(minmer_index)} windows"
    )
    log(
        f"[wfmash::mashmap] Filtered {filtered}/{total_windows} k-mers "
        f"occurring > {count_threshold} times"
    )

    return MinmerIndex(
        minmer_index=minmer_index,
        unique_hashes=uh,
        endpoint_offsets=eoff,
        endpoints=endpoints,
        hg_numerator=params.hg_numerator,
        count_threshold=count_threshold,
        total_windows=total_windows,
        filtered_windows=filtered,
    )


def _build_endpoints(records: np.ndarray) -> np.ndarray:
    """OPEN/CLOSE endpoint rows, with back-to-back same-hash intervals
    coalesced.

    The reference appends OPEN(wpos)/CLOSE(wpos_end) pairs per hash in scan
    order, and when the previous CLOSE for the same hash sits exactly at the
    new record's wpos it extends that CLOSE to the new wpos_end instead
    (winSketch.hpp:379-387) — i.e. ADJACENT intervals (prev.wpos_end ==
    next.wpos) merge into one. This re-merges the w-sized chunks emitted by
    the winnowing stage. We additionally require matching seq_id (the
    reference's guard does not check it, which could merge coincidentally
    adjacent intervals across sequence boundaries — a thread-layout-dependent
    corruption we do not reproduce).

    Per (hash, seq_id), intervals are disjoint and sorted, so the merged
    intervals are found by a vectorized adjacency scan.
    """
    if len(records) == 0:
        return np.empty(0, dtype=ENDPOINT_DTYPE)
    # per hash, (seq_id, wpos) scan order
    order = np.lexsort((records["wpos"], records["seq_id"], records["hash"]))
    r = records[order]
    adjacent = np.zeros(len(r), dtype=bool)
    if len(r) > 1:
        adjacent[1:] = (
            (r["hash"][1:] == r["hash"][:-1])
            & (r["seq_id"][1:] == r["seq_id"][:-1])
            & (r["wpos"][1:] == r["wpos_end"][:-1])
        )
    keep = ~adjacent  # start of each merged interval
    group_id = np.cumsum(keep) - 1
    n_groups = group_id[-1] + 1
    g_hash = r["hash"][keep]
    g_seq = r["seq_id"][keep]
    g_wpos = r["wpos"][keep]
    g_wend = np.zeros(n_groups, dtype=np.int64)
    np.maximum.at(g_wend, group_id, r["wpos_end"])  # last == max within group

    out = np.empty(2 * n_groups, dtype=ENDPOINT_DTYPE)
    out["hash"][0::2] = g_hash
    out["hash"][1::2] = g_hash
    out["seq_id"][0::2] = g_seq
    out["seq_id"][1::2] = g_seq
    out["pos"][0::2] = g_wpos
    out["pos"][1::2] = g_wend
    out["side"][0::2] = SIDE_OPEN
    out["side"][1::2] = SIDE_CLOSE
    return out


def _csr_by_hash(endpoints: np.ndarray):
    """Group endpoints by hash (each hash's rows kept in scan order, i.e.
    sorted by (seq_id, pos, side-pairing as emitted))."""
    if len(endpoints) == 0:
        return np.empty(0, dtype=np.uint64), np.zeros(1, dtype=np.int64)
    # stable sort by hash preserves per-hash emission order
    order = np.argsort(endpoints["hash"], kind="stable")
    endpoints[:] = endpoints[order]
    uh, first = np.unique(endpoints["hash"], return_index=True)
    offsets = np.concatenate([first, [len(endpoints)]]).astype(np.int64)
    return uh, offsets
