"""Mapping driver: fragments -> L1/L2 -> merge/filter/scaffold -> PAF.

Equivalent of skch::Map (reference: src/map/include/computeMap.hpp:60-1175):

* targets split into <= index_by_size-bp subsets, indexed and mapped
  serially (computeMap.hpp:295-327, 396-776) — on a device mesh these subsets
  become index shards mapped in parallel (wfmash_tpu.parallel);
* each query is cut into windowLength fragments (+ one tail fragment
  anchored at the end when the length is not a multiple;
  computeMap.hpp:560-631);
* per fragment: sketch -> L1 candidates (per target group, hypergeometric
  two-pass) -> L2 -> identity gate (computeMap.hpp:879-1061);
* per query: boundary clamp, union-find chain merge, weak/plane-sweep/
  length/sparsify/scaffold filters (filterSubsetMappings,
  computeMap.hpp:1076-1165);
* output: PAF rows (mappingOutput.hpp:74-138), optionally buffered for the
  ONETOONE reference-axis sweep (computeMap.hpp:789-866).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field

import numpy as np

from ..io.fasta import FastaReader
from ..io.seqids import SequenceIdManager
from ..params import (
    FILTER_MAP,
    FILTER_ONETOONE,
    MapParams,
    STRAND_FWD,
    STRAND_REV,
    fixed,
)
from ..sketch.minhash import sketch_fragment
from . import stats
from .chain import CHAIN_DTYPE, merge_mappings_with_chains, scale_complexity, scale_identity
from .filters import (
    boundary_sanity_check,
    filter_by_scaffolds,
    filter_false_high_identity,
    filter_weak_mappings,
    sparsify_mappings,
)
from .l1l2 import (
    FLAG_REV,
    L1Candidate,
    L2Mapping,
    MAPPING_DTYPE,
    compute_l1_candidate_regions,
    compute_l2_mapped_regions,
    get_seed_interval_points,
)
from .sweep import filter_by_group


def log(msg: str) -> None:
    print(msg, file=sys.stderr)


@dataclass
class QueryResult:
    query_name: str
    query_len: int
    mappings: np.ndarray      # MAPPING_DTYPE
    chain_info: np.ndarray    # CHAIN_DTYPE


class Mapper:
    def __init__(self, params: MapParams, id_manager: SequenceIdManager):
        self.params = params
        self.idm = id_manager
        self._group_arr = np.asarray(id_manager.group_ids, dtype=np.int64)
        self._len_arr = np.asarray(id_manager.lengths, dtype=np.int64)
        self.device_l1 = None     # optional map/l1_device.py backend
        self.device_l2 = None     # optional map/l2_device.py backend
        self._l2_gate_cache: dict = {}   # see _l2_gate

        if params.stage1_topANI_filter:
            self.sketch_cutoffs = stats.compute_sketch_cutoffs(
                params.sketch_size,
                params.kmer_size,
                params.ANIDiff,
                params.ANIDiffConf,
                fixed.ss_table_max,
            )
        else:
            self.sketch_cutoffs = np.ones(
                int(min(params.sketch_size, fixed.ss_table_max)) + 1, dtype=np.int32
            )
        self.cached_minimum_hits = max(
            params.minimum_hits,
            stats.estimate_minimum_hits_relaxed(
                params.sketch_size,
                params.kmer_size,
                params.percentage_identity,
                fixed.confidence_interval,
            ),
        )

    # -- helpers -------------------------------------------------------------
    def group_of(self, seq_ids):
        return self._group_arr[np.asarray(seq_ids, dtype=np.int64)]

    def seq_len_of(self, seq_id: int) -> int:
        return int(self._len_arr[seq_id])

    def _minimum_hits_for(self, q_len: int, sketch) -> int:
        p = self.params
        if q_len == p.window_length:
            return self.cached_minimum_hits
        return max(
            p.minimum_hits,
            stats.estimate_minimum_hits_relaxed(
                sketch.sketch_size, p.kmer_size, p.percentage_identity,
                fixed.confidence_interval,
            ),
        )

    def _host_l1(self, sketch, q_len: int, query_seq_id: int,
                 query_group: int, minimum_hits: int,
                 index) -> list[L1Candidate]:
        """Host L1: k-way posting merge + per-target-group two-pass sweep
        (computeMap.hpp:963-982)."""
        p = self.params

        # native fast path: ONE call covers the endpoint gather, the
        # self/group/lower-triangular skip, the (seq,pos,side) sort,
        # every target group's sweep AND the proximal join (the
        # numpy gather+lexsort and the per-group ctypes loop both
        # dominated the mapping wall at ~12k calls per LPA run)
        from ..native import l1_fragment_native, l1_sweep_multi_native

        starts, ends = index.lookup(sketch.hashes)
        nat = l1_fragment_native(
            index.endpoints_soa(),
            np.ascontiguousarray(starts, np.int64),
            np.ascontiguousarray(ends, np.int64),
            self._group_arr, query_group, query_seq_id,
            p.skip_self or p.skip_prefix, p.lower_triangular,
            p.skip_prefix,
            max(0, q_len - p.window_length), minimum_hits,
            p.stage1_topANI_filter, p.stage2_full_scan,
            sketch.sketch_size, max(1.0, p.sketch_size / 1000.0),
            self.sketch_cutoffs, p.window_length)
        if nat is not None:
            return [L1Candidate(seq_id=a, range_start=b, range_end=c,
                                intersection_size=d)
                    for (a, b, c, d) in nat]

        pts = get_seed_interval_points(
            sketch, index, query_seq_id, query_group, self.group_of, p
        )
        l1: list[L1Candidate] = []
        n = len(pts)
        if n == 0:
            return l1

        if p.skip_prefix:
            groups = np.asarray(self.group_of(pts["seq_id"]))
            cut = np.flatnonzero(groups[1:] != groups[:-1]) + 1
            grp_b = np.empty(len(cut) + 2, np.int64)
            grp_b[0] = 0
            grp_b[1:-1] = cut
            grp_b[-1] = n
        else:
            grp_b = np.array([0, n], np.int64)
        nat = l1_sweep_multi_native(
            np.ascontiguousarray(pts["pos"], dtype=np.int64),
            np.ascontiguousarray(pts["seq_id"], dtype=np.int64),
            np.ascontiguousarray(pts["side"], dtype=np.int8),
            np.ascontiguousarray(pts["hash"], dtype=np.uint64),
            grp_b, max(0, q_len - p.window_length), minimum_hits,
            p.stage1_topANI_filter, p.stage2_full_scan,
            sketch.sketch_size, max(1.0, p.sketch_size / 1000.0),
            self.sketch_cutoffs, p.window_length)
        if nat is not None:
            return [L1Candidate(seq_id=a, range_start=b, range_end=c,
                                intersection_size=d)
                    for (a, b, c, d) in nat]

        # Python fallback: per-group spec sweep
        groups = self.group_of(pts["seq_id"])
        i = 0
        while i < n:
            j = i + 1
            if p.skip_prefix:
                while j < n and groups[j] == groups[i]:
                    j += 1
            else:
                j = n
            compute_l1_candidate_regions(
                sketch.sketch_size, q_len, pts[i:j], minimum_hits, p,
                self.sketch_cutoffs, l1,
            )
            i = j
        return l1

    # -- per-fragment --------------------------------------------------------
    def map_fragment(self, frag_seq, frag_index: int, query_seq_id: int,
                     query_group: int, index, l1=None,
                     sketch=None) -> list[tuple]:
        """Returns raw mapping tuples for one fragment. `l1` supplies
        precomputed (device-batched) L1 candidates; None = host L1;
        `sketch` supplies a precomputed (batch-native) sketch."""
        p = self.params
        q_len = len(frag_seq)
        if sketch is None:
            sketch = sketch_fragment(frag_seq, p.kmer_size,
                                     p.sketch_size)
        if sketch.sketch_size == 0 or sketch.kmer_complexity < p.kmer_complexity_threshold:
            return []
        minimum_hits = self._minimum_hits_for(q_len, sketch)
        if l1 is None:
            l1 = self._host_l1(sketch, q_len, query_seq_id, query_group,
                               minimum_hits, index)
        if not l1:
            return []
        return self._l2_collect(sketch, q_len, frag_index, l1, index)

    def _l2_collect(self, sketch, q_len: int, frag_index: int,
                    l1: list[L1Candidate], index,
                    l2_of: list | None = None) -> list[tuple]:
        # L2 per group run over l1, candidates in intersection-desc order
        # (computeMap.hpp:895-918, 988-1060). l2_of: optional list
        # parallel to l1 with precomputed (device) L2 mappings per
        # candidate — None entries re-run the host walk.
        p = self.params
        of_cand: dict = {}
        if l2_of is not None:
            of_cand = {id(c): r for c, r in zip(l1, l2_of)}
        out = []
        # the topANI cutoff is CONSTANT across the fragment
        # (index.hg_numerator is a parameter, never mutated), so the
        # sorted-order break equals a prefix filter — compute once
        cutoff_j = None
        if p.stage1_topANI_filter:
            jaccard_sim = index.hg_numerator / sketch.sketch_size
            mash_dist = stats.j2md(jaccard_sim, p.kmer_size)
            cutoff_ani = max(0.0, (1.0 - mash_dist) - p.ANIDiff)
            cutoff_j = stats.md2j(1.0 - cutoff_ani, p.kmer_size)

        # per-group sort + cutoff prefix -> one flat candidate list
        sel: list = []
        b = 0
        nl1 = len(l1)
        while b < nl1:
            e = b + 1
            if p.skip_prefix:
                g = self.group_of([l1[b].seq_id])[0]
                while e < nl1 and self.group_of([l1[e].seq_id])[0] == g:
                    e += 1
            else:
                e = nl1
            group_cands = l1[b:e]
            if p.stage1_topANI_filter:
                group_cands = sorted(
                    group_cands, key=lambda c: -c.intersection_size
                )
            for cand in group_cands:
                if (cutoff_j is not None and cand.intersection_size
                        / sketch.sketch_size < cutoff_j):
                    break
                sel.append(cand)
            b = e

        # batched native L2: one call for every selected candidate
        # (l2_walk_multi); falls back to the per-candidate spec path
        l2s_of: list | None = None
        if of_cand or not sel:
            pass
        else:
            from ..native import l2_walk_multi_native

            rows = l2_walk_multi_native(
                index.soa(),
                np.asarray([c.seq_id for c in sel], np.int64),
                np.asarray([c.range_start for c in sel], np.int64),
                np.asarray([c.range_end for c in sel], np.int64),
                np.ascontiguousarray(sketch.hashes, np.uint64),
                np.ascontiguousarray(sketch.strand, np.int8),
                max(0, q_len - p.window_length), p.window_length)
            l2s_of = rows   # raw (seq, pos, start, end, shared, fwd)

        # the identity gate and its scaled value depend only on
        # (shared_sketch_size, sketch_size) for fixed params — memoized
        # (the float32 chains were ~15us per L2 result; bit-identical)
        q_start = frag_index * p.window_length
        scaled_c = scale_complexity(sketch.kmer_complexity)
        gate = self._l2_gate
        ssize = sketch.sketch_size
        for ci, cand in enumerate(sel):
            l2s = of_cand.get(id(cand))
            if l2s is None and l2s_of is not None:
                # native rows consumed raw — building L2Mapping tuples
                # just to unpack them was ~0.15 s/run of object churn
                for (a, bb, _c, _d, ee, f) in l2s_of[ci]:
                    keep, scaled_id = gate(ee, ssize)
                    if keep:
                        out.append((a, bb, q_start, q_len, 1, ee,
                                    scaled_id, 0 if f > 0 else FLAG_REV,
                                    scaled_c))
                continue
            if l2s is None:
                l2s = compute_l2_mapped_regions(sketch, q_len, cand,
                                                index, p)
            for l2 in l2s:
                keep, scaled_id = gate(l2.shared_sketch_size, ssize)
                if keep:
                    flags = FLAG_REV if l2.strand == STRAND_REV else 0
                    out.append(
                        (
                            l2.seq_id,
                            l2.mean_optimal_pos,
                            q_start,
                            q_len,
                            1,
                            l2.shared_sketch_size,
                            scaled_id,
                            flags,
                            scaled_c,
                        )
                    )
        return out

    def _l2_gate(self, shared: int, ssize: int):
        """Memoized identity gate + scaled identity for one L2 result
        (the float32 chains of computeMap.hpp:1016-1048, verbatim)."""
        key = (shared, ssize)
        got = self._l2_gate_cache.get(key)
        if got is not None:
            return got
        p = self.params
        mash_dist = stats.j2md(
            float(np.float32(1.0 * shared / ssize)), p.kmer_size)
        nuc_identity = float(np.float32(1.0 - float(np.float32(mash_dist))))
        nuc_id_ub = float(
            np.float32(
                1.0
                - float(
                    np.float32(
                        stats.md_lower_bound(
                            mash_dist, ssize, p.kmer_size,
                            fixed.confidence_interval,
                        )
                    )
                )
            )
        )
        keep = bool(
            (
                p.keep_low_pct_id
                and np.float32(nuc_id_ub) >= np.float32(p.percentage_identity)
            ) or np.float32(nuc_identity) >= np.float32(p.percentage_identity)
        )
        got = (keep, scale_identity(nuc_identity))
        self._l2_gate_cache[key] = got
        return got

    def _fragments(self, seq: bytes):
        """(frag_index, frag_seq) pairs: w-length windows + the w-length
        tail window when the query is not a multiple of w
        (computeMap.hpp:560-631)."""
        p = self.params
        qlen = len(seq)
        n_frag = qlen // p.window_length
        out = [(i, seq[i * p.window_length:(i + 1) * p.window_length])
               for i in range(n_frag)]
        if n_frag >= 1 and qlen % p.window_length != 0:
            out.append((n_frag, seq[qlen - p.window_length:]))
        return out

    # -- per-query -----------------------------------------------------------
    def map_query(self, query_name: str, seq: bytes, index) -> QueryResult:
        p = self.params
        seq_id = self.idm.get_sequence_id(query_name)
        group = int(self.group_of([seq_id])[0])
        qlen = len(seq)

        raw: list[tuple] = []
        frags = self._fragments(seq)
        sks = self._sketch_all(seq, frags)
        if self.device_l1 is not None:
            # ALL fragments of the query (tail included — it is w bases
            # long by construction) in ONE batched device L1 call
            # (the batched kernel must see batches)
            sketches = []
            for (fi, frag), sk in zip(frags, sks):
                ok = (sk.sketch_size > 0
                      and sk.kmer_complexity >= p.kmer_complexity_threshold)
                sketches.append((fi, frag, sk, ok))
            elig = [(fi, frag, sk) for fi, frag, sk, ok in sketches if ok]
            dev_rows = self.device_l1.candidates([dict(
                hashes=sk.hashes, n=sk.sketch_size, q_len=len(frag),
                q_seqid=seq_id, q_group=group,
                min_hits=self._minimum_hits_for(len(frag), sk))
                for fi, frag, sk in elig]) if elig else []
            for (fi, frag, sk), rows in zip(elig, dev_rows):
                if rows is None:
                    raw.extend(self.map_fragment(frag, fi, seq_id, group,
                                                 index))
                else:
                    l1 = [L1Candidate(*r) for r in rows]
                    if l1:
                        raw.extend(self._l2_collect(sk, len(frag), fi, l1,
                                                    index))
        else:
            raw.extend(self._map_fragments_host(frags, sks, seq_id,
                                                group, index))

        return self.finish_query(query_name, qlen, seq_id, raw)

    def _map_fragments_host(self, frags, sks, seq_id, group, index):
        """Host path for all of one query's fragments: gates, then ONE
        native L1 call for the whole query (l1_fragment_multi), then
        the per-fragment L2. Per-fragment map_fragment is the fallback
        (lib absent / key-packing overflow)."""
        from ..native import l1_fragment_multi_native

        p = self.params
        elig = []
        for (fi, frag), sk in zip(frags, sks):
            if (sk.sketch_size == 0
                    or sk.kmer_complexity < p.kmer_complexity_threshold):
                continue
            elig.append((fi, frag, sk))
        if not elig:
            return []
        starts_l, ends_l, s_off = [], [], [0]
        wl = np.empty(len(elig), np.int64)
        mh = np.empty(len(elig), np.int64)
        ss = np.empty(len(elig), np.int64)
        for i, (fi, frag, sk) in enumerate(elig):
            st, en = index.lookup(sk.hashes)
            starts_l.append(np.ascontiguousarray(st, np.int64))
            ends_l.append(np.ascontiguousarray(en, np.int64))
            s_off.append(s_off[-1] + len(st))
            wl[i] = max(0, len(frag) - p.window_length)
            mh[i] = self._minimum_hits_for(len(frag), sk)
            ss[i] = sk.sketch_size
        multi = l1_fragment_multi_native(
            index.endpoints_soa(),
            np.concatenate(starts_l) if starts_l else np.empty(0, np.int64),
            np.concatenate(ends_l) if ends_l else np.empty(0, np.int64),
            np.asarray(s_off, np.int64), self._group_arr, group, seq_id,
            p.skip_self or p.skip_prefix, p.lower_triangular,
            p.skip_prefix, wl, mh, p.stage1_topANI_filter,
            p.stage2_full_scan, ss, max(1.0, p.sketch_size / 1000.0),
            self.sketch_cutoffs, p.window_length)
        raw: list[tuple] = []
        if multi is None:
            for fi, frag, sk in elig:
                raw.extend(self.map_fragment(frag, fi, seq_id, group,
                                             index, sketch=sk))
            return raw
        for (fi, frag, sk), rows in zip(elig, multi):
            if rows is None:          # per-fragment overflow fallback
                raw.extend(self.map_fragment(frag, fi, seq_id, group,
                                             index, sketch=sk))
                continue
            l1 = [L1Candidate(*r) for r in rows]
            if l1:
                raw.extend(self._l2_collect(sk, len(frag), fi, l1,
                                            index))
        return raw

    def _sketch_all(self, seq: bytes, frags):
        """All fragment sketches in one native call (winnow.cpp:
        sketch_fragments); per-fragment spec path as fallback."""
        from ..native import sketch_fragments_native

        p = self.params
        nat = sketch_fragments_native(seq, p.kmer_size, p.window_length,
                                      p.sketch_size)
        if nat is not None and len(nat) == len(frags):
            return nat
        return [sketch_fragment(frag, p.kmer_size, p.sketch_size)
                for _, frag in frags]

    def sketch_query(self, seq: bytes):
        """Phase-1 worker (fork-poolable, pure host): fragment + sketch.
        Returns [(frag_index, q_len, sketch, ok)]."""
        p = self.params
        out = []
        for fi, frag in self._fragments(seq):
            sk = sketch_fragment(frag, p.kmer_size, p.sketch_size)
            ok = (sk.sketch_size > 0
                  and sk.kmer_complexity >= p.kmer_complexity_threshold)
            out.append((fi, len(frag), sk, ok))
        return out

    def map_query_precomputed(self, query_name: str, qlen: int,
                              entries, index) -> QueryResult:
        """Phase-3 worker: L2 + filters for a query whose sketches and
        (device) L1 candidates were computed in earlier phases.
        entries: [(frag_index, q_len, sketch, l1_rows | None[, l2s])] —
        None rows re-run the host L1 (device cap overflow fallback);
        the optional l2s list (parallel to l1_rows) carries device-L2
        results, None entries re-running the host walk."""
        seq_id = self.idm.get_sequence_id(query_name)
        group = int(self.group_of([seq_id])[0])
        raw: list[tuple] = []
        for ent in entries:
            fi, q_len, sk, rows = ent[:4]
            l2s = ent[4] if len(ent) > 4 else None
            if rows is None:
                l1 = self._host_l1(sk, q_len, seq_id, group,
                                   self._minimum_hits_for(q_len, sk), index)
                l2s = None
            else:
                l1 = [L1Candidate(*r) for r in rows]
            if l1:
                raw.extend(self._l2_collect(sk, q_len, fi, l1, index,
                                            l2_of=l2s))
        return self.finish_query(query_name, qlen, seq_id, raw)

    def finish_query(self, query_name: str, qlen: int, seq_id: int,
                     raw: list[tuple]) -> QueryResult:
        mappings = (
            np.array(raw, dtype=MAPPING_DTYPE) if raw else np.empty(0, MAPPING_DTYPE)
        )
        # per-fragment results arrive in fragment order; the reference sorts
        # each fragment's l2Mappings by (refSeqId, refStartPos)
        # (computeMap.hpp:920) — our fragment loop emits per-candidate order,
        # so sort within fragment runs
        mappings = self._sort_within_fragments(mappings)

        boundary_sanity_check(mappings, qlen, self.seq_len_of)
        mappings, chain_info = self.filter_subset_mappings(mappings, seq_id, qlen)
        return QueryResult(query_name, qlen, mappings, chain_info)

    def _sort_within_fragments(self, m: np.ndarray) -> np.ndarray:
        if len(m) < 2:
            return m
        order = np.lexsort((m["ref_start"], m["ref_seq_id"], m["query_start"]))
        return m[order]

    # -- filterSubsetMappings (computeMap.hpp:1076-1165) ----------------------
    def filter_subset_mappings(self, mappings: np.ndarray, query_seq_id: int,
                               query_len: int, scaffold_writer=None,
                               scaffold_anchor_keys: set | None = None):
        p = self.params
        if len(mappings) == 0:
            return mappings, np.empty(0, CHAIN_DTYPE)

        raw = mappings.copy()
        merged, chain_info = merge_mappings_with_chains(mappings, p.chain_gap, p)

        if p.merge_mappings and p.split:
            keep = filter_weak_mappings(
                merged,
                math.floor(p.block_length / p.window_length),
                p,
                self.seq_len_of,
                query_len,
            )
            merged, chain_info = merged[keep], chain_info[keep]

            if p.filter_mode in (FILTER_MAP, FILTER_ONETOONE):
                pre_filter = merged
                merged = filter_by_group(
                    merged, p.num_mappings_for_segment - 1, False,
                    self.group_of, self.seq_len_of, p,
                )
                # re-match by row bytes against the pre-filter superset so
                # ch:Z:id.pos.len chain tags survive the group filter's
                # resort (reference keeps chainInfo parallel through
                # filterByGroup, mappingOutput.hpp:25-169)
                chain_info = self._rebuild_chain_info(
                    chain_info, merged, pre_filter)

            if p.filter_length_mismatches:
                keep = filter_false_high_identity(merged, p)
                merged, chain_info = merged[keep], chain_info[keep]

            keep = sparsify_mappings(merged, p)
            merged, chain_info = merged[keep], chain_info[keep]

            survived = filter_by_scaffolds(
                merged, p, self.group_of, self.seq_len_of, scaffold_writer,
                anchor_keys_out=scaffold_anchor_keys,
            )
            chain_info = self._rebuild_chain_info(chain_info, survived, merged)
            merged = survived
            return merged, chain_info
        else:
            out = mappings
            if p.filter_mode in (FILTER_MAP, FILTER_ONETOONE):
                out = filter_by_group(
                    out, p.num_mappings_for_segment - 1, False,
                    self.group_of, self.seq_len_of, p,
                )
            out = filter_by_scaffolds(
                out, p, self.group_of, self.seq_len_of, scaffold_writer,
                anchor_keys_out=scaffold_anchor_keys,
            )
            chain_info = np.zeros(len(out), dtype=CHAIN_DTYPE)
            chain_info["chain_id"] = np.arange(len(out))
            chain_info["chain_pos"] = 1
            chain_info["chain_len"] = 1
            return out, chain_info

    def _rebuild_chain_info(self, chain_info: np.ndarray, subset: np.ndarray,
                            superset: np.ndarray | None = None) -> np.ndarray:
        """Re-associate chain info rows after a filter that reordered or
        subset the mappings. Rows are matched by full record equality (the
        reference keeps chainInfo parallel through moves; our array filters
        need an explicit re-match)."""
        if superset is None or len(chain_info) != len(superset):
            # chain info lost alignment (e.g. after filter_by_group's resort)
            # — fall back to per-row identity chains, which only affects the
            # ch:Z tag grouping of already-filtered rows.
            out = np.zeros(len(subset), dtype=CHAIN_DTYPE)
            out["chain_id"] = np.arange(len(subset))
            out["chain_pos"] = 1
            out["chain_len"] = 1
            return out
        # match subset rows back to superset rows by bytes
        sup_view = superset.tobytes()
        row_size = superset.dtype.itemsize
        index_of: dict[bytes, list[int]] = {}
        for i in range(len(superset)):
            index_of.setdefault(
                sup_view[i * row_size : (i + 1) * row_size], []
            ).append(i)
        out = np.zeros(len(subset), dtype=CHAIN_DTYPE)
        sub_view = subset.tobytes()
        for i in range(len(subset)):
            key = sub_view[i * row_size : (i + 1) * row_size]
            j = index_of[key].pop(0)
            out[i] = chain_info[j]
        return out
