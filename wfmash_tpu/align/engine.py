"""Alignment driver: PAF records -> WFA jobs -> PAF/SAM output.

Equivalent of align::Aligner (reference:
src/align/include/computeAlignments.hpp:142-738):

* scan the mapping PAF once; per record apply target padding (both ends)
  and query padding (only at chain ends: start padding when chain_pos==1
  AND the record is the last piece, end padding when chain_pos==chain_len
  — reproducing the reference's write-only-at-last-piece behavior,
  computeAlignments.hpp:267-289);
* fetch the target with up to wflign_max_len_minor extra head/tail context
  (used by patching), fetch the query region, uppercase/N-normalize both,
  reverse-complement the query for '-' mappings;
* run the biWFA path (align/biwfa.py) per record;
* emit PAF rows (or SAM), preserving input record order.

The WFA engine is pluggable; by default the batched JAX engine handles
records grouped into shape buckets, with the host engine as fallback.
"""

from __future__ import annotations

import sys

import numpy as np

from ..io.fasta import FastaReader
from ..io.paf import parse_paf_line
from ..params import AlignParams, fixed
from ..sketch.kmers import normalize, reverse_complement
from .biwfa import AlignmentJob, HostWfaEngine, align_record, write_paf_row
from .wfa_np import Penalties


def log(msg):
    print(msg, file=sys.stderr)


def parse_mashmap_row(line: str, target_padding: int, query_padding: int):
    """parseMashmapRow (computeAlignments.hpp:195-303). Returns a dict or
    raises on malformed input."""
    rec = parse_paf_line(line)
    # estimated identity from column 13 ("id:f:0.93" in mapping output)
    parts = line.rstrip("\n").split("\t")
    if len(parts) < 13:
        raise ValueError("invalid mashmap mapping record")
    id_tok = parts[12].split(":")
    try:
        mm_id = float(id_tok[-1])
    except ValueError:
        mm_id = fixed.percentage_identity

    chain_id, chain_length, chain_pos = -1, 1, 1
    if len(parts) > 14:
        ch = parts[14].split(":")
        if len(ch) == 3 and ch[0] == "ch" and ch[1] == "Z":
            sub = ch[2].split(".")
            if len(sub) == 3:
                chain_id, chain_pos, chain_length = (
                    int(sub[0]), int(sub[1]), int(sub[2])
                )

    r_start, r_end = rec["target_start"], rec["target_end"]
    q_start, q_end = rec["query_start"], rec["query_end"]
    ref_len = rec["target_len"]
    query_len = rec["query_len"]

    if target_padding > 0:
        r_start = r_start - target_padding if r_start >= target_padding else 0
        r_end = r_end + target_padding if r_end + target_padding <= ref_len else ref_len

    if query_padding > 0:
        qs = q_start
        qe = q_end
        if chain_pos == 1:
            qs = q_start - query_padding if q_start >= query_padding else 0
        if chain_pos == chain_length:
            if q_end + query_padding <= query_len:
                qe = q_end + query_padding
            else:
                qe = query_len
            # the reference commits BOTH coordinates only on the last piece
            q_start, q_end = qs, qe

    if r_start >= ref_len or r_end > ref_len:
        raise ValueError("coordinates exceed reference length")

    return {
        "query_name": rec["query_name"],
        "query_len": query_len,
        "q_start": q_start,
        "q_end": q_end,
        "is_rev": rec["strand"] == "-",
        "target_name": rec["target_name"],
        "target_len": ref_len,
        "r_start": r_start,
        "r_end": r_end,
        "mm_id": mm_id,
        "chain_id": chain_id,
        "chain_length": chain_length,
        "chain_pos": chain_pos,
    }


class _NormCache:
    """Normalized-full-sequence cache for the align driver.

    Each PAF record re-fetches (and re-normalizes) its padded slices;
    on all-vs-all workloads every sequence is touched hundreds of
    times. Caching bytes(normalize(full_sequence)) once per name makes
    build_job a pair of slices. Bounded by a shared byte budget
    (WFMASH_TPU_ALIGN_SEQ_CACHE_MB, default 1024 across both readers);
    sequences that would exceed it fall back to per-record fetches, so
    the streaming-memory story survives at scale."""

    def __init__(self, reader: FastaReader, budget: list):
        self._reader = reader
        self._budget = budget        # [remaining_bytes], shared
        self._seqs: dict = {}

    def get(self, name: str):
        got = self._seqs.get(name)
        if got is not None:
            return got
        if name in self._seqs:       # previously over budget
            return None
        if self._reader.seq_len(name) > self._budget[0]:
            self._seqs[name] = None
            return None
        seq = bytes(normalize(self._reader.fetch(name)))
        self._budget[0] -= len(seq)
        self._seqs[name] = seq
        return seq


def build_job(row, ref_reader: FastaReader, query_reader: FastaReader,
              params: AlignParams, ref_cache: _NormCache | None = None,
              query_cache: _NormCache | None = None) -> AlignmentJob:
    """createSeqRecord + processAlignment prep (computeAlignments.hpp:
    582-723). The target is extracted WITHOUT the extra
    +-wflign_max_len_minor context: the reference fetches it
    (computeAlignments.hpp:609-621) but then skips past it — the
    pointer handed to do_biwfa_alignment starts at rStartPos and the
    length excludes the tail padding (computeAlignments.hpp:675,706) —
    so the live path never reads those bases. Verified vestigial."""
    tfull = ref_cache.get(row["target_name"]) if ref_cache else None
    if tfull is not None:
        target = tfull[row["r_start"]:row["r_end"]]
    else:
        target = bytes(normalize(ref_reader.fetch(
            row["target_name"], row["r_start"], row["r_end"] - 1)))
    qfull = query_cache.get(row["query_name"]) if query_cache else None
    if qfull is not None:
        qnorm = qfull[row["q_start"]:row["q_end"]]
    else:
        qnorm = bytes(normalize(query_reader.fetch(
            row["query_name"], row["q_start"], row["q_end"] - 1)))
    if row["is_rev"]:
        query = bytes(reverse_complement(bytearray(qnorm)))
    else:
        query = qnorm
    # lengths come from the FETCHED regions, not the PAF spans: merged
    # chains can claim q_end/r_end beyond the sequence (the reference
    # emits those rows too and its faidx fetch clamps, so queryLen /
    # refLen are the clamped values — computeAlignments.hpp:645-651)
    return AlignmentJob(
        query_name=row["query_name"],
        query=query,
        query_total_length=row["query_len"],
        query_offset=row["q_start"],
        query_length=len(query),
        query_is_rev=row["is_rev"],
        target_name=row["target_name"],
        target=target,
        target_total_length=row["target_len"],
        target_offset=row["r_start"],
        target_length=len(target),
        mashmap_estimated_identity=row["mm_id"],
        chain_id=row["chain_id"],
        chain_length=row["chain_length"],
        chain_pos=row["chain_pos"],
    )


def align_penalties(params: AlignParams) -> Penalties:
    """The patching penalties every WFA engine aligns with."""
    return Penalties(
        params.wfa_patching_mismatch_score,
        params.wfa_patching_gap_opening_score1,
        params.wfa_patching_gap_extension_score1,
        params.wfa_patching_gap_opening_score2,
        params.wfa_patching_gap_extension_score2,
    )


def _on_gpu() -> bool:
    import jax

    return jax.default_backend() == "gpu"


def make_engine(params: AlignParams):
    """WFA engine by platform. On a GPU: anchored segmentation
    (align/segmented.py) with the segment solver on the card and the
    batched JAX engine for escalations. Elsewhere: the native host
    engine. WFMASH_TPU_WFA_ENGINE=host forces the plain host engine;
    WFMASH_TPU_SEGMENTED=0 restores exact whole-block biWFA on the
    device engine (fidelity comparisons), =1 forces segmentation."""
    import os

    penalties = align_penalties(params)
    n_threads = max(1, int(getattr(params, "threads", 1)))
    if os.environ.get("WFMASH_TPU_WFA_ENGINE", "auto") == "host":
        eng = HostWfaEngine(penalties)
        eng.threads = n_threads
        return eng

    seg = os.environ.get("WFMASH_TPU_SEGMENTED", "auto")
    if seg == "auto" and not _on_gpu():
        from ..native import get_wfa_lib

        if get_wfa_lib() is not None:
            log("[wfmash::align] no GPU; using the native engine "
                "(override with WFMASH_TPU_SEGMENTED=1)")
            return BudgetedHostEngine(penalties, params)
    from .wfa_jax import JaxWfaEngine

    engine = JaxWfaEngine(penalties)
    engine.threads = n_threads
    if seg != "0":
        seng = _build_segmented(penalties, engine)
        if getattr(params, "strict_parity", False):
            seng.detect_inversions = False
        return seng
    return engine


def _build_segmented(penalties, exact_engine):
    """SegmentedEngine over the tiered segment solver, sharded over all
    devices when a host has more than one GPU."""
    import os

    import jax

    from .segmented import SegmentedEngine
    from .wfa_seg import TieredSegmentSolver

    # WFMASH_TPU_ALIGN_MESH: shard segment batches over all devices
    # ("auto" = when >1 GPU; "force" = also on the virtual CPU mesh, used
    # by tests; "0" = off)
    mesh = None
    mm = os.environ.get("WFMASH_TPU_ALIGN_MESH", "auto")
    n_dev = len(jax.devices())
    if mm != "0" and n_dev > 1 and (mm == "force" or _on_gpu()):
        import numpy as _np
        from jax.sharding import Mesh

        mesh = Mesh(_np.asarray(jax.devices()), ("data",))
    solver = TieredSegmentSolver(penalties, mesh=mesh)
    return SegmentedEngine(penalties, exact_engine, solver=solver)


class BudgetedHostEngine(HostWfaEngine):
    """Host exact engine with two escape hatches:

    * **score cap** — a main (end-to-end) block whose exact score
      exceeds WFMASH_TPU_HOST_SCORE_CAP (default 100; 0 disables) is
      re-solved via anchored segmentation with exact native WFA per
      piece (`segmented.segmented_host_align`). The probe costs one
      capped sweep (~1 ms); diverted blocks are the divergent tail
      whose O(score^2) exact cost dominates the align wall — on LPA
      they hold ~75% of the work in ~40% of the records. Near-optimal
      instead of exact for those blocks (fidelity ledger).
    * **memory budget** — a block whose full-history footprint would
      exceed WFMASH_TPU_WFA_MEM_MB raises WfaMemoryBudget from the
      native engine and reroutes through the full segmented engine
      (bounded per-piece memory) — the rare giant/divergent block
      cannot OOM the host."""

    def __init__(self, penalties, params):
        import os

        super().__init__(penalties)
        self.threads = max(1, int(getattr(params, "threads", 1)))
        self._params = params
        self._full = None
        self.score_cap = int(os.environ.get(
            "WFMASH_TPU_HOST_SCORE_CAP", "100"))
        # boundary-patch score cap: a patch whose ends-free score would
        # exceed it keeps the ORIGINAL (pre-erode) alignment instead —
        # replayable either way; the reference would compute the
        # expensive patch (fidelity ledger). 0 disables.
        self.patch_cap = int(os.environ.get(
            "WFMASH_TPU_PATCH_SCORE_CAP", "0"))
        # solve free-begin head patches on the reversed sequences
        # (score-identical, cheaper band — see align(); ledgered)
        self.fast_head_patch = os.environ.get(
            "WFMASH_TPU_FAST_HEAD_PATCH", "1") != "0"

    def _probe_failed(self, query: bytes, target: bytes):
        """Score-cap exceeded: segmented reroute (None => whole-block
        exact path)."""
        from ..native import WfaMemoryBudget
        from .segmented import segmented_host_align

        try:
            return segmented_host_align(query, target, self.penalties)
        except WfaMemoryBudget:
            return None               # giant-skew piece: whole-block path

    def _exact_or_reroute(self, query: bytes, target: bytes,
                          ends_free=None):
        """Whole-block exact solve with the memory-budget reroute —
        the tail of align(), callable directly when the probe and
        segmented stages are already known to have run (native batch
        statuses 2/4)."""
        from ..native import WfaMemoryBudget

        try:
            return super().align(query, target, ends_free)
        except WfaMemoryBudget:
            log(f"[wfmash::align] exact history over budget for a "
                f"{len(query)}x{len(target)} block; segmented reroute")
            if self._full is None:
                from .wfa_jax import JaxWfaEngine

                eng = JaxWfaEngine(self.penalties)
                eng.threads = max(
                    1, int(getattr(self._params, "threads", 1)))
                self._full = _build_segmented(self.penalties, eng)
            return self._full.align(query, target, ends_free)

    def align_batch(self, jobs, bounds=None):
        """Batch fast path: ALL end-to-end main blocks run in ONE
        native call (segsolve.cpp:host_align_blocks — capped probe +
        segmented reroute + small-block exact per block), and all
        ends-free patch jobs in one more; only the rare leftovers
        (unplannable blocks, memory-budget reroutes, solver fallbacks)
        go through align() per job. Output is byte-identical to the
        per-job path (tested).

        bounds: optional per-job score upper bounds (a valid candidate
        alignment's score, e.g. the eroded ops a boundary patch
        replaces). Ends-free jobs prune their wavefronts with them —
        the optimum never exceeds a valid bound, so results are
        unchanged (bit-identical, see wfa.cpp)."""
        from ..native import WfaMemoryBudget, wfa_align_batch_native

        if int(getattr(self, "threads", 1)) > 1:
            # multi-core hosts: the per-job thread pool (GIL released
            # inside the native calls) beats one serial batched call
            return super().align_batch(jobs)
        out: list = [None] * len(jobs)
        todo = list(range(len(jobs)))
        main_idx = [i for i, (q, t, ef) in enumerate(jobs) if ef is None]
        if len(main_idx) >= 2:
            import os as _os

            from ..native import host_align_blocks_native

            got = host_align_blocks_native(
                [(jobs[i][0], jobs[i][1]) for i in main_idx],
                self.penalties, self.score_cap, 2000,
                int(_os.environ.get("WFMASH_TPU_SEG_TARGET", "256")),
                int(_os.environ.get("WFMASH_TPU_REFINE_CAP", "800")))
            if got is not NotImplemented:
                done = set()
                for i, (st, runs) in zip(main_idx, got):
                    if st in (0, 1):      # exact / segmented, complete
                        out[i] = runs
                        done.add(i)
                    elif st in (2, 4):
                        # probe + segmented already ran natively
                        # (unplannable / memory budget): go straight to
                        # the exact solve + reroute tail
                        out[i] = self._exact_or_reroute(
                            jobs[i][0], jobs[i][1])
                        done.add(i)
                    # st 3 (solver fallback): full per-job path below
                todo = [i for i in todo if i not in done]
        # batch the ends-free patch jobs too (one native call); head
        # patches (free-begin only) apply the reversal transform first
        # — see align() for the rationale
        ef_idx, ef_pieces, ef_spans, ef_rev, ef_bound = [], [], [], [], []
        for i in todo:
            q, t, ef = jobs[i]
            if ef is None:
                continue
            head = ((ef.target_begin or ef.query_begin)
                    and not (ef.target_end or ef.query_end))
            if head and self.fast_head_patch:
                ef_pieces.append((q[::-1], t[::-1]))
                ef_spans.append((0, ef.target_begin, 0, ef.query_begin))
                ef_rev.append(True)
            else:
                ef_pieces.append((q, t))
                ef_spans.append((ef.target_begin, ef.target_end,
                                 ef.query_begin, ef.query_end))
                ef_rev.append(False)
            ef_bound.append(bounds[i] if bounds is not None
                            and i < len(bounds) else None)
            ef_idx.append(i)
        if len(ef_idx) >= 2:
            if self.patch_cap > 0:
                caps = [self.patch_cap if b is None
                        else min(b, self.patch_cap) for b in ef_bound]
            elif any(b is not None for b in ef_bound):
                # a valid bound can never reject (optimum <= bound), so
                # -1 per-piece results cannot occur here
                caps = [-1 if b is None else b for b in ef_bound]
            else:
                caps = None
            solved = None
            try:
                solved = wfa_align_batch_native(
                    ef_pieces, self.penalties, max_scores=caps,
                    ends_free=ef_spans)
            except WfaMemoryBudget:   # pragma: no cover - giant patch
                solved = None
            if solved is not None:
                done = set()
                for i, rev, (_, ops) in zip(ef_idx, ef_rev, solved):
                    out[i] = (None if ops is None
                              else (ops[::-1] if rev else ops))
                    done.add(i)
                todo = [i for i in todo if i not in done]
        for i in todo:
            q, t, ef = jobs[i]
            out[i] = self.align(q, t, ef)
        return out

    def align(self, query: bytes, target: bytes, ends_free=None):
        from ..native import WfaMemoryBudget
        from .biwfa import EndsFree
        from .wfa_vec import wfa_align

        if (ends_free is not None and self.fast_head_patch
                and (ends_free.target_begin or ends_free.query_begin)
                and not (ends_free.target_end or ends_free.query_end)):
            # head patches are free-BEGIN on both sides: the wavefront
            # seeds span the whole erode width, so every level combines
            # ~|tb|+|qb| live lanes even at score 0. Solving the
            # REVERSED sequences with the frees moved to the END is the
            # same problem (score-identical; the returned CIGAR is one
            # of the co-optimal alignments — tie-breaks differ from the
            # forward solve, fidelity ledger) but seeds a single lane:
            # measured 0.58 ms -> 0.21 ms per head patch on LPA.
            cap = self.patch_cap if self.patch_cap > 0 else None
            _, ops = wfa_align(
                query[::-1], target[::-1], self.penalties,
                EndsFree(target_end=ends_free.target_begin,
                         query_end=ends_free.query_begin),
                max_score=cap)
            return None if ops is None else ops[::-1]
        if ends_free is not None and self.patch_cap > 0:
            _, ops = wfa_align(query, target, self.penalties, ends_free,
                               max_score=self.patch_cap)
            return ops                     # None => caller keeps original
        if (ends_free is None and self.score_cap > 0
                and min(len(query), len(target)) >= 2000):
            try:
                _, ops = wfa_align(query, target, self.penalties, None,
                                   max_score=self.score_cap)
            except WfaMemoryBudget:   # pragma: no cover - tiny cap
                ops = None
            if ops is not None:
                return ops
            ops = self._probe_failed(query, target)
            if ops is not None:
                return ops
        return self._exact_or_reroute(query, target, ends_free)


def run_alignment(params: AlignParams, out, engine=None) -> None:
    """Align every record of params.mashmap_paf_file and write PAF/SAM to
    out. engine: a WFA engine (default: make_engine(params))."""
    if params.target_padding < 0 or params.query_padding < 0:
        # unfinalized params would silently align UNPADDED records
        # (parse_mashmap_row skips padding <= 0) — apply the reference's
        # defaults for the standard 1 kb mapping window instead
        params.finalize(1000)
    ref_reader = FastaReader(params.ref_sequences[0])
    query_reader = FastaReader(params.query_sequences[0])

    rows = []
    with open(params.mashmap_paf_file) as fh:
        for line in fh:
            if not line.strip():
                continue
            try:
                rows.append(
                    parse_mashmap_row(
                        line, params.target_padding, params.query_padding
                    )
                )
            except (ValueError, IndexError) as e:
                log(f"[wfmash::align] Warning: Skipping invalid record: {e}")

    total_q = sum(r["q_end"] - r["q_start"] for r in rows)
    log(
        f"[wfmash::align] Found {len(rows)} mapping records for alignment "
        f"({total_q} query bp)"
    )

    if params.sam_format:
        write_sam_header(out, ref_reader)

    import os as _osc

    budget = [int(float(_osc.environ.get(
        "WFMASH_TPU_ALIGN_SEQ_CACHE_MB", "1024")) * 1e6)]
    ref_cache = _NormCache(ref_reader, budget)
    query_cache = (_NormCache(query_reader, budget)
                   if params.query_sequences[0] != params.ref_sequences[0]
                   else ref_cache)

    if engine is None:
        engine = make_engine(params)
    # a failure on the device path stops the run; only host engines get
    # the per-record retry below
    device_path = _on_gpu() and not isinstance(engine, HostWfaEngine)

    from .biwfa import align_records_batched

    from ..utils.progress import ProgressMeter

    # STREAMING driver (reference: computeAlignments.hpp:391-438 streams
    # records through taskflow with thread-local readers): sequences are
    # fetched, aligned, written, and dropped one batch at a time, so
    # peak memory is one batch of padded pairs — not the whole run.
    # Batches are bounded by TOTAL BP, not record count: pooling every
    # record of a run into one engine batch fills the segment solver's
    # calls with ~all segments of the run, while multi-GB runs still
    # stream.
    import os as _os2

    n_aligned = 0
    n_dumped = 0
    batch_bp = int(_os2.environ.get("WFMASH_TPU_ALIGN_BATCH_BP",
                                    str(256 * 1024 * 1024)))
    # --path-patching-tsv (reference: parse_args.hpp:146, a
    # WFA_PNG_TSV_TIMING debug build option; row format adapted to this
    # engine's erode + ends-free batched patch phase)
    tsv = None
    if getattr(params, "path_patching_tsv", None):
        tsv = open(params.path_patching_tsv, "w")
        tsv.write("query.name\tquery.start\tquery.end\ttarget.name\t"
                  "target.start\ttarget.end\tkind\tquery.eroded.bp\t"
                  "target.eroded.bp\tpatch.applied\n")
    # -G/-u: per-alignment segmentation-plan dumps (debugplot.py)
    wf_tsv = getattr(params, "wavefront_tsv_prefix", None)
    wf_png = getattr(params, "wavefront_png_prefix", None)

    def dump_plans(chunk, base_idx):
        import re as _re

        from .debugplot import plan_rows, write_plan_png, write_plan_tsv

        def safe(name):
            # sequence names may contain path characters ('/': PacBio
            # read naming; PanSN '#') — sanitize for the filename
            return _re.sub(r"[^A-Za-z0-9._-]", "_", name)

        for di, job in enumerate(chunk):
            rows = plan_rows(job.query, job.target)
            stem = (f"{base_idx + di:06d}.{safe(job.query_name)}_"
                    f"{job.query_offset}_{safe(job.target_name)}_"
                    f"{job.target_offset}")
            if wf_tsv:
                write_plan_tsv(f"{wf_tsv}{stem}.tsv", job, rows)
            if wf_png:
                write_plan_png(f"{wf_png}{stem}.png", rows,
                               job.query_length, job.target_length,
                               getattr(params, "wfplot_max_size", 1500))
    meter = ProgressMeter(max(len(rows), 1), "[wfmash::align] aligning")
    start = 0
    while start < len(rows):
        chunk = []
        bp = 0
        while start < len(rows) and (not chunk or bp < batch_bp):
            row = rows[start]
            start += 1
            try:
                job = build_job(row, ref_reader, query_reader, params,
                                ref_cache, query_cache)
                chunk.append(job)
                bp += job.query_length + job.target_length
            except Exception as e:
                log(f"[wfmash::align] Error extracting record: {e}")
                meter.increment(1)
        if wf_tsv or wf_png:
            dump_plans(chunk, n_dumped)
            n_dumped += len(chunk)
        if hasattr(engine, "inversions"):
            engine.inversions = []
        try:
            # mains as one device batch, boundary patches as two more
            # device batches (biwfa.patch_boundaries_batched) — the
            # round-2 fork-pool-per-record patch phase kept the device
            # idle; host work is now just erode/splice/swizzle (the
            # engine itself fork-pools any leftover host WFA leaves)
            trace = [] if tsv is not None else None
            ops_list = align_records_batched(
                chunk, engine, params.disable_chain_patching,
                trace=trace,
            )
            if tsv is not None:
                for ji, kind, q_er, t_er, applied in trace:
                    j = chunk[ji]
                    qs = j.query_offset
                    qe_ = j.query_offset + j.query_length
                    ts = j.target_offset
                    te_ = j.target_offset + j.target_length
                    tsv.write(
                        f"{j.query_name}\t{qs}\t{qe_}\t{j.target_name}\t"
                        f"{ts}\t{te_}\t{kind}\t{q_er}\t{t_er}\t"
                        f"{int(applied)}\n")
                tsv.flush()   # crash loses at most one chunk of rows
        except Exception as e:
            if device_path:
                raise
            log(f"[wfmash::align] Batch error, falling back per-record: {e}")
            if tsv is not None:
                # the per-record fallback path has no patch trace — mark
                # the gap instead of silently under-reporting
                tsv.write(f"# batch fallback: patch rows unavailable for "
                          f"{len(chunk)} records\n")
                tsv.flush()
            ops_list = []
            collected = []
            for idx, job in enumerate(chunk):
                if hasattr(engine, "inversions"):
                    engine.inversions = []
                try:
                    ops_list.append(
                        align_record(job, engine, params.disable_chain_patching)
                    )
                except Exception as e2:
                    log(f"[wfmash::align] Error processing record: {e2}")
                    ops_list.append(None)
                # re-key per-record inversion hits to the chunk index
                for inv in getattr(engine, "inversions", []):
                    inv["ji"] = idx
                    collected.append(inv)
            if hasattr(engine, "inversions"):
                engine.inversions = collected
        meter.increment(len(chunk))
        for job, ops in zip(chunk, ops_list):
            if ops is None:
                continue
            if params.sam_format:
                from .sam import write_sam_row

                write_sam_row(
                    out, job, ops,
                    params.min_identity, params.min_alignment_length,
                    params.min_block_identity,
                    no_seq=params.no_seq_in_sam, emit_md=params.emit_md_tag,
                )
            else:
                write_paf_row(
                    out, job, ops,
                    params.min_identity, params.min_alignment_length,
                    params.min_block_identity,
                )
            n_aligned += 1

        # inversion patches detected inside this chunk's blocks emit as
        # extra rows (PAF only — wflign_patch.cpp:2361-2392 semantics)
        if (not params.sam_format
                and not getattr(params, "strict_parity", False)
                and getattr(engine, "inversions", None)):
            from .biwfa import write_inversion_row

            for inv in engine.inversions:
                job = chunk[inv["ji"]]
                if write_inversion_row(out, job, inv):
                    n_aligned += 1

    meter.finish()
    if tsv is not None:
        tsv.close()
    log(f"[wfmash::align] total aligned records = {n_aligned}")
    import os as _os

    if _os.environ.get("WFMASH_TPU_PERF"):
        from ..utils import perf

        snap = perf.snapshot()
        for k in sorted(snap):
            log(f"[wfmash::perf] {k} = {snap[k]:.3f}")


def write_sam_header(out, ref_reader: FastaReader) -> None:
    for rec in ref_reader.records:
        out.write(f"@SQ\tSN:{rec.name}\tLN:{rec.length}\n")
    from .. import __version__

    out.write(f"@PG\tID:wfmash\tPN:wfmash\tVN:{__version__}\tCL:wfmash\n")
