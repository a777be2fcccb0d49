#!/usr/bin/env python3
"""Smoke test of the main path on one NVIDIA GPU.

    python chip_smoke.py            # phases 0-3 on one card
    python chip_smoke.py --four     # only the 4-card sharded paths

Everything runs in this one process, which holds the card; the plain
wfa_np reference runs in spawned helper processes that never import JAX.

0. Device: fails unless JAX's first device is a GPU; prints its kind,
   the device count and nvidia-smi's name and power limit.
1. Kernels against their references, on the card: the CUDA segment
   solver and its plain-JAX twin on seeded jobs for every tier (end to
   end and ends-free) against wfa_np.wfa_align, and DeviceL1/DeviceL2
   on one wave of real fragments against the native walk. All integer
   results, compared exactly.
2. End to end: a seeded 12 Mb genome pair (2% SNPs, 0.2% indels, a
   500 kb inversion, a 1 Mb deletion, a 300 kb duplication — the shape
   of upstream's yeast-pair test), BGZF + .fai, through cli.main:
   device mapping byte-identical to host mapping, every CIGAR replays,
   query coverage > 0.95, and the rows whose CIGAR differs from the
   host engine's are counted.
3. Counters: cold and warm wall, compiles in the warm pass (must be 0),
   device L1/L2 and segment calls, escalations, peak device memory.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Any failed check exits non-zero before it is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ACGT = np.frombuffer(b"ACGT", np.uint8)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------


def phase_device(want_platform="gpu"):
    import jax

    devs = jax.devices()
    d = devs[0]
    check(d.platform == want_platform,
          f"JAX found no {want_platform} (first device: {d.platform})")
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    if want_platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        check(smi.returncode == 0, "nvidia-smi failed: " + smi.stderr)
        for line in smi.stdout.strip().splitlines():
            log(f"[nvidia-smi] {line.strip()}")
    return dict(platform=d.platform, kind=d.device_kind, count=len(devs))


# ---------------------------------------------------------------------------
# phase 1: kernels against their references
# ---------------------------------------------------------------------------


def _mutate(rng, seq: np.ndarray, sub: float, indel: float) -> np.ndarray:
    """Substitutions plus 1-4 bp insertions/deletions at rate indel."""
    out = seq.copy()
    m = rng.random(len(out)) < sub
    out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
    n_ev = rng.binomial(len(out), indel)
    for pos in sorted(rng.integers(0, max(len(out), 1), n_ev))[::-1]:
        ln = int(rng.integers(1, 5))
        if rng.random() < 0.5:
            out = np.concatenate([out[:pos], rng.integers(0, 4, ln),
                                  out[pos:]])
        else:
            out = np.concatenate([out[:pos], out[pos + ln:]])
    return out.astype(np.uint8)


def _dna(a: np.ndarray) -> bytes:
    return ACGT[a].tobytes()


def make_tier_jobs(tier_idx: int, n: int, seed: int):
    """n seeded jobs shaped for one tier: (q, t, EndsFree | None)."""
    from wfmash_tpu.align.wfa_np import EndsFree

    rng = np.random.default_rng(seed * 100 + tier_idx)
    jobs = []
    while len(jobs) < n:
        if tier_idx == 0:      # anchored segments, some boundary patches
            ln = int(rng.integers(80, 400))
            t = rng.integers(0, 4, ln).astype(np.uint8)
            q = _mutate(rng, t, rng.uniform(0.0, 0.05), 0.005)
        elif tier_idx == 1:    # divergent or skewed segments
            ln = int(rng.integers(200, 480))
            t = rng.integers(0, 4, ln).astype(np.uint8)
            q = _mutate(rng, t, rng.uniform(0.05, 0.12), 0.01)
            if rng.random() < 0.3:
                cut = int(rng.integers(0, len(q) - 90))
                q = np.concatenate([q[:cut], q[cut + 80:]])
        elif tier_idx == 2:    # mid-size pieces, structural gaps
            ln = int(rng.integers(600, 1700))
            t = rng.integers(0, 4, ln).astype(np.uint8)
            q = _mutate(rng, t, rng.uniform(0.01, 0.06), 0.003)
        elif tier_idx == 3:    # long low-divergence boundary patches
            ln = int(rng.integers(1000, 3800))
            t = rng.integers(0, 4, ln).astype(np.uint8)
            q = _mutate(rng, t, rng.uniform(0.002, 0.02), 0.001)
        else:                  # deep score budget, narrow band
            ln = int(rng.integers(300, 900))
            t = rng.integers(0, 4, ln).astype(np.uint8)
            q = _mutate(rng, t, rng.uniform(0.04, 0.12), 0.004)
        ef = None
        r = rng.random()
        if tier_idx == 4:
            pass               # deep tier: end-to-end pieces only
        elif r < 0.15:
            ef = EndsFree(target_begin=len(t), query_begin=len(q))
        elif r < 0.3:
            ef = EndsFree(target_end=len(t), query_end=len(q))
        elif r < 0.4 and tier_idx == 2:
            flank = rng.integers(0, 4, 200).astype(np.uint8)
            t = np.concatenate([flank, q, flank[::-1]])
            ef = EndsFree(target_begin=400, target_end=400)
        jobs.append((_dna(q), _dna(t), ef))
    return jobs


def _ref_align(args):
    """wfa_np reference (runs in a spawned helper: numpy only)."""
    from wfmash_tpu.align.wfa_np import wfa_align

    q, t, ef, p = args
    return wfa_align(q, t, p, ef)


def reference_solve(jobs, penalties, procs):
    """wfa_np on every job; procs > 1 spreads it over spawned helpers
    (run as a script: spawn re-imports this file as the main module)."""
    import multiprocessing as mp

    args = [(q, t, ef, penalties) for q, t, ef in jobs]
    if procs <= 1:
        return [_ref_align(a) for a in args]
    with mp.get_context("spawn").Pool(procs) as pool:
        return pool.map_async(_ref_align, args, chunksize=4).get(900)


def _timed_solve(solver, jobs):
    st: list = []
    unc: list = []
    t0 = time.perf_counter()
    got = solver.solve(jobs, status=st, uncertified=unc)
    return got, st, unc, time.perf_counter() - t0


def kernel_call_seconds(tier, jobs, reps=5):
    """Median time of one device call on the tier's first chunk: input
    already on the device, output waited for. Excludes host packing and
    decoding, which _timed_solve includes."""
    import statistics

    import jax

    from wfmash_tpu.align.wfa_seg import _run_seg

    buf, _, _ = tier.pack_chunk(list(range(min(len(jobs), tier.max_call))),
                                jobs)
    x = jax.device_put(buf)

    def call():
        return jax.block_until_ready(_run_seg(
            x, penalties=tier.p, K=tier.K, smax=tier.smax, maxr=tier.maxr,
            kernel=tier.kernel))

    call()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), x.shape[0]


def phase_segment_kernels(penalties, n_per_tier=(4096, 1024, 512, 256, 512),
                          seed=7, kernels=("cuda", "lax"), procs=16):
    """Every tier with every kernel on the same seeded jobs; compares
    each kernel with wfa_np and the kernels with each other. Returns
    {tier: {kernel: warm seconds}}."""
    from wfmash_tpu.align.wfa_np import score_cigar
    from wfmash_tpu.align.wfa_seg import TieredSegmentSolver

    solvers = {k: TieredSegmentSolver(penalties, kernel=k) for k in kernels}
    times = {}
    for ti, n in enumerate(n_per_tier):
        tiers = [s.tiers[ti] for s in solvers.values()]
        jobs = [j for j in make_tier_jobs(ti, n, seed)
                if tiers[0].accepts(len(j[0]), len(j[1]), j[2])]
        t0 = time.perf_counter()
        ref = reference_solve(jobs, penalties, procs)
        t_ref = time.perf_counter() - t0
        res = {}
        calls = {}
        for k, tier in zip(kernels, tiers):
            _timed_solve(tier, jobs)                 # compile + warm up
            got, st, unc, dt = _timed_solve(tier, jobs)
            res[k] = (got, st, unc)
            times.setdefault(ti, {})[k] = dt
            calls[k] = kernel_call_seconds(tier, jobs)
        name = f"t{ti + 1}(K={tiers[0].K},smax={tiers[0].smax})"
        log(f"[seg] {name} one_call rows={calls[kernels[0]][1]} " + " ".join(
            f"{k}_s={calls[k][0]:.6f}" for k in kernels))
        for k in kernels:
            got, st, _ = res[k]
            n_ok = sum(s == "ok" for s in st)
            # ends-free scores leave out the free end gaps that
            # score_cigar counts, so only end-to-end scores are compared
            bad = sum(1 for g, s, (rs, rops), j in zip(got, st, ref, jobs)
                      if s == "ok" and (g != rops or (
                          j[2] is None and score_cigar(g, penalties) != rs)))
            log(f"[seg] {name} kernel={k} jobs={len(jobs)} ok={n_ok} "
                f"mismatches_vs_wfa_np={bad} warm_s={times[ti][k]:.4f} "
                f"(wfa_np on {procs} procs "
                f"{t_ref:.1f}s)")
            check(bad == 0, f"{name}: {bad} {k} CIGARs differ from wfa_np")
            check(n_ok >= len(jobs) // 2,
                  f"{name}: only {n_ok}/{len(jobs)} jobs solved by {k}")
        if len(kernels) == 2:
            # results, statuses and banded (uncertified) CIGARs agree
            ra, rb = res[kernels[0]], res[kernels[1]]
            diff = sum(1 for a, b in zip(zip(*ra), zip(*rb)) if a != b)
            log(f"[seg] {name} {kernels[0]}_vs_{kernels[1]} "
                f"mismatches={diff}")
            check(diff == 0, f"{name}: kernels disagree on {diff} jobs")
    return times


def phase_long_sweep(penalties, bp=50_000, seed=7):
    """The exact XLA sweep engine (JaxWfaEngine) on one ~50 kb record:
    the CIGAR replays and its score equals the native exact WFA's."""
    from wfmash_tpu.align import cigar as C
    from wfmash_tpu.align.wfa_jax import JaxWfaEngine
    from wfmash_tpu.align.wfa_np import score_cigar
    from wfmash_tpu.native import wfa_align_ops_native

    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, bp).astype(np.uint8)
    q, t = _dna(_mutate(rng, t, 0.01, 0.001)), _dna(t)
    eng = JaxWfaEngine(penalties)
    t0 = time.perf_counter()
    ops = eng.align_batch([(q, t, None)], allow_seg=False)[0]
    dt = time.perf_counter() - t0
    ref_score, _ = wfa_align_ops_native(q, t, penalties)
    ok = C.validate(ops, q, t, 0, 0)
    score = score_cigar(ops, penalties)
    log(f"[sweep] {len(q)}x{len(t)} bp xla_sweep_s={dt:.2f} replay={ok} "
        f"score={score} native_score={ref_score}")
    check(ok and score == ref_score,
          "the XLA sweep engine differs from the native exact WFA")


def mapping_fixture(bp=2_000_000, seed=7, n_frags=256):
    """Index over a seeded target and one wave of real query fragments
    (mutated windows of the same genome), with the host candidates."""
    from wfmash_tpu.index.build import build_index
    from wfmash_tpu.map import l1l2
    from wfmash_tpu.map.stats import compute_sketch_cutoffs
    from wfmash_tpu.params import MapParams
    from wfmash_tpu.sketch.minhash import sketch_fragment

    rng = np.random.default_rng(seed)
    mp = MapParams(percentage_identity=0.9, auto_pct_identity=False)
    mp.ref_sequences = mp.query_sequences = ["x"]
    mp = mp.finalize()
    base = rng.integers(0, 4, bp).astype(np.uint8)
    other = _mutate(rng, base[bp // 4: 3 * bp // 4], 0.03, 0.002)
    seqs = [(0, _dna(base)), (1, _dna(other))]
    index = build_index(mp, seqs, log=lambda m: None)
    group_arr = np.array([0, 1], np.int32)
    cutoffs = compute_sketch_cutoffs(mp.sketch_size, mp.kmer_size, 0.0,
                                     0.999)
    W = mp.window_length
    frags, rows = [], []
    for _ in range(n_frags):
        a = int(rng.integers(0, bp - W))
        frag = _dna(_mutate(rng, base[a:a + W], rng.uniform(0, 0.08), 0))
        frag = frag[:W].ljust(W, b"A")
        sk = sketch_fragment(frag, mp.kmer_size, mp.sketch_size)
        if sk.sketch_size == 0:
            continue
        frags.append(dict(hashes=sk.hashes, n=sk.sketch_size, q_len=W,
                          q_seqid=99, q_group=99, min_hits=2))
        rows.append(sk)
    group_of = lambda ids: group_arr[np.asarray(ids, np.int64)]  # noqa
    host_l1 = []
    for f, sk in zip(frags, rows):
        pts = l1l2.get_seed_interval_points(sk, index, 99, 99, group_of, mp)
        out: list = []
        # one L1 pass per target group under -Y (map/engine.py does the
        # same split)
        groups = group_of(pts["seq_id"]) if len(pts) else []
        i = 0
        while i < len(pts):
            j = i + 1
            if mp.skip_prefix:
                while j < len(pts) and groups[j] == groups[i]:
                    j += 1
            else:
                j = len(pts)
            l1l2.compute_l1_candidate_regions(sk.sketch_size, W, pts[i:j],
                                              2, mp, cutoffs, out)
            i = j
        host_l1.append(out)
    return dict(mp=mp, index=index, group_arr=group_arr, cutoffs=cutoffs,
                frags=frags, sketches=rows, host_l1=host_l1)


def phase_mapping_kernels(fx):
    """DeviceL1 and DeviceL2 against the native/host walk."""
    from wfmash_tpu.map import l1l2
    from wfmash_tpu.map.l1_device import DeviceL1
    from wfmash_tpu.map.l2_device import DeviceL2

    mp = fx["mp"]
    dev = DeviceL1(fx["index"], fx["group_arr"], mp, fx["cutoffs"])
    got = dev.candidates(fx["frags"])
    t0 = time.perf_counter()
    dev.candidates(fx["frags"])
    t_l1 = time.perf_counter() - t0
    exp = [[(c.seq_id, c.range_start, c.range_end, c.intersection_size)
            for c in cs] for cs in fx["host_l1"]]
    n_dev = sum(g is not None for g in got)
    bad = sum(1 for g, e in zip(got, exp) if g is not None and g != e)
    n_cand = sum(len(e) for e in exp)
    log(f"[l1] fragments={len(exp)} on_device={n_dev} candidates={n_cand} "
        f"mismatches_vs_host={bad} warm_s={t_l1:.4f}")
    check(bad == 0 and n_dev == len(exp) and n_cand > 0,
          "DeviceL1 differs from the host L1")
    rows, exp2 = [], []
    for sk, cands in zip(fx["sketches"], fx["host_l1"]):
        for cand in cands[:4]:
            rows.append((sk, mp.window_length, cand))
            exp2.append(l1l2.compute_l2_mapped_regions(
                sk, mp.window_length, cand, fx["index"], mp))
    l2 = DeviceL2(fx["index"], mp)
    got2 = l2.walk(rows)
    t0 = time.perf_counter()
    l2.walk(rows)
    t_l2 = time.perf_counter() - t0

    def key(ms):
        return [(a.seq_id, a.mean_optimal_pos, a.optimal_start,
                 a.optimal_end, a.shared_sketch_size, a.strand)
                for a in ms]

    n_dev2 = sum(g is not None for g in got2)
    bad2 = sum(1 for g, e in zip(got2, exp2)
               if g is not None and key(g) != key(e))
    log(f"[l2] candidates={len(rows)} on_device={n_dev2} "
        f"mismatches_vs_native={bad2} warm_s={t_l2:.4f}")
    check(bad2 == 0 and n_dev2 >= len(rows) // 2,
          "DeviceL2 differs from the native walk")
    return dev


# ---------------------------------------------------------------------------
# phase 2: end to end
# ---------------------------------------------------------------------------


def make_inputs(data_dir, bp, seed):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from scale_demo import make_pair, write_fasta_bgzf

    os.makedirs(data_dir, exist_ok=True)
    pt = os.path.join(data_dir, "anc.fa.gz")
    pq = os.path.join(data_dir, "der.fa.gz")
    anc, der = make_pair(bp, seed)
    write_fasta_bgzf(pt, "anc", anc)
    write_fasta_bgzf(pq, "der", der)
    return pt, pq, _dna(anc), _dna(der)


def run_cli(args, out_path, env=None):
    """cli.main in this process, stdout to out_path; returns seconds."""
    from wfmash_tpu import cli

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        t0 = time.perf_counter()
        with open(out_path, "w") as fh, contextlib.redirect_stdout(fh):
            rc = cli.main(args)
        dt = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(rc == 0, f"cli.main({args}) returned {rc}")
    return dt


def cigar_rows(path):
    rows = {}
    for ln in open(path):
        f = ln.rstrip("\n").split("\t")
        cg = next((c[5:] for c in f[12:] if c.startswith("cg:Z:")), None)
        if cg is not None:
            rows[tuple(f[:4]) + (f[5], f[7], f[8])] = (f, cg)
    return rows


def validate_alignment(path, anc_b, der_b):
    """Every CIGAR replays against the inputs; returns (rows, coverage)."""
    from wfmash_tpu.align import cigar as C
    from wfmash_tpu.sketch.kmers import reverse_complement

    rows = cigar_rows(path)
    check(rows, "no aligned rows")
    der_rc = bytes(reverse_complement(np.frombuffer(der_b, np.uint8)))
    bad = 0
    for f, cg in rows.values():
        qs, qe, ts = int(f[2]), int(f[3]), int(f[7])
        if f[4] == "-":
            ok = C.validate(C.parse(cg), der_rc, anc_b, len(der_b) - qe, ts)
        else:
            ok = C.validate(C.parse(cg), der_b, anc_b, qs, ts)
        bad += not ok
    iv = sorted((int(f[2]), int(f[3])) for f, _ in rows.values())
    cov = end = 0
    for a, b in iv:
        a = max(a, end)
        if b > a:
            cov += b - a
            end = b
    return len(rows), bad, cov / len(der_b)


class CompileCounter:
    """Counts XLA backend compiles (and their seconds) while active."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax

        self.n = 0
        self.secs = 0.0
        self.on = False
        jax.monitoring.register_event_duration_secs_listener(self._cb)

    def _cb(self, event, secs, **_):
        if self.on and event == self.EVENT:
            self.n += 1
            self.secs += secs

    def window(self):
        self.n, self.secs, self.on = 0, 0.0, True
        return self

    def stop(self):
        self.on = False


def phase_end_to_end(inputs, threads, out_dir, min_coverage=0.95):
    """inputs: (target path, query path, target bytes, query bytes)."""
    import jax

    from wfmash_tpu import cli
    from wfmash_tpu.align.engine import BudgetedHostEngine, run_alignment
    from wfmash_tpu.utils import perf

    pt, pq, anc_b, der_b = inputs
    os.makedirs(out_dir, exist_ok=True)
    base = [pt, pq, "-t", str(threads)]
    p = lambda name: os.path.join(out_dir, name)  # noqa: E731
    cc = CompileCounter()

    # mapping: device vs native host, byte for byte
    perf.reset()
    t_map = run_cli(base + ["-m"], p("map_dev.paf"))
    map_calls = perf.get("map.device_calls")
    l2_calls = perf.get("map.l2_device_calls")
    t_map_h = run_cli(base + ["-m"], p("map_host.paf"),
                      env={"WFMASH_TPU_DEVICE_L1": "0"})
    same = open(p("map_dev.paf"), "rb").read() == \
        open(p("map_host.paf"), "rb").read()
    n_map = sum(1 for _ in open(p("map_dev.paf")))
    log(f"[e2e] mapping rows={n_map} device_wall_s={t_map:.2f} "
        f"host_wall_s={t_map_h:.2f} device_L1_calls={map_calls:.0f} "
        f"device_L2_calls={l2_calls:.0f} paf_byte_identical={same}")
    check(same, "device mapping PAF differs from the host mapping")
    check(map_calls > 0, "mapping made no device calls")

    # full pipeline, cold then warm
    perf.reset()
    win = cc.window()
    t_cold = run_cli(base, p("aln.paf"))
    win.stop()
    cold_compiles, cold_compile_s = win.n, win.secs
    cold = perf.snapshot()
    perf.reset()
    win = cc.window()
    t_warm = run_cli(base, p("aln_warm.paf"))
    win.stop()
    warm = perf.snapshot()
    log(f"[e2e] cold_wall_s={t_cold:.2f} (compiles={cold_compiles}, "
        f"compile_s={cold_compile_s:.2f}) warm_wall_s={t_warm:.2f} "
        f"warm_compiles={win.n} warm_compile_s={win.secs:.2f}")
    check(win.n == 0, f"{win.n} compiles inside the warm pass")
    check(open(p("aln.paf"), "rb").read() == open(p("aln_warm.paf"),
                                                  "rb").read(),
          "warm run output differs from the cold run")
    n_rows, bad, cov = validate_alignment(p("aln.paf"), anc_b, der_b)
    log(f"[e2e] aligned_rows={n_rows} cigar_replay_failures={bad} "
        f"query_coverage={cov:.4f}")
    check(bad == 0, f"{bad} CIGARs fail replay")
    check(cov > min_coverage, f"query coverage {cov:.4f} <= {min_coverage}")

    # the host engine on the same mapping, for the CIGAR-difference count
    _, ap, _, _ = cli.parse_args(base)
    ap.mashmap_paf_file = p("map_dev.paf")
    t0 = time.perf_counter()
    with open(p("aln_host.paf"), "w") as fh:
        run_alignment(ap, fh, engine=BudgetedHostEngine(
            _penalties(ap), ap))
    t_host = time.perf_counter() - t0
    dev_rows, host_rows = cigar_rows(p("aln.paf")), cigar_rows(
        p("aln_host.paf"))
    n_diff = sum(1 for k, (_, cg) in dev_rows.items()
                 if k not in host_rows or host_rows[k][1] != cg)
    log(f"[e2e] host_engine_align_s={t_host:.2f} rows_device={len(dev_rows)}"
        f" rows_host={len(host_rows)} cigar_differs_from_host={n_diff}")

    # counters of the warm pass
    seg = {k[len("align.seg_jobs."):]: int(v) for k, v in warm.items()
           if k.startswith("align.seg_jobs.")}
    keys = ("map.device_calls", "map.l2_device_calls", "align.device_calls",
            "align.segments", "align.escalated", "align.exact_blocks",
            "align.banded", "align.sweep_calls", "align.host_leaves",
            "align.resweep_jobs",
            "align.inv_candidates", "align.plan_s", "align.seg_solve_s",
            "align.exact_s", "align.inversion_s")
    log("[counters] warm " + " ".join(
        f"{k}={warm.get(k, 0):.6g}" for k in keys))
    log(f"[counters] segment_jobs_per_tier {json.dumps(seg, sort_keys=True)}")
    log(f"[counters] cold align.device_calls="
        f"{cold.get('align.device_calls', 0):.0f}")
    check(sum(seg.values()) > 0, "the device solved no segments")
    check(warm.get("map.device_calls", 0) > 0, "no device mapping calls")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[counters] peak_bytes_in_use="
        f"{stats.get('peak_bytes_in_use', 'n/a')}")


def _penalties(ap):
    from wfmash_tpu.align.engine import align_penalties

    return align_penalties(ap)


# ---------------------------------------------------------------------------
# --four: the multi-device paths
# ---------------------------------------------------------------------------


def phase_four(fx, inputs, threads, out_dir):
    """fx: a mapping_fixture; inputs as for phase_end_to_end."""
    import jax

    from wfmash_tpu.map.l1_device import DeviceL1
    from wfmash_tpu.parallel.mesh import ShardedDeviceL1, make_mesh

    check(len(jax.devices()) >= 4, "--four needs 4 devices")
    # sharded L1 on a (2, 2) mesh against the single-device DeviceL1
    mp = fx["mp"]
    one = DeviceL1(fx["index"], fx["group_arr"], mp, fx["cutoffs"])
    sh = ShardedDeviceL1(fx["index"], fx["group_arr"], mp, fx["cutoffs"],
                         make_mesh(2, 2))
    a, b = one.candidates(fx["frags"]), sh.candidates(fx["frags"])
    diff = sum(1 for x, y in zip(a, b) if x != y)
    log(f"[four] sharded_L1 mesh=(2,2) fragments={len(a)} "
        f"candidates={sum(len(x or []) for x in a)} mismatches={diff}")
    check(diff == 0 and len(a) == len(b), "sharded L1 differs")

    # alignment sharded over 4 devices against devices[:1]
    pt, pq, anc_b, der_b = inputs
    os.makedirs(out_dir, exist_ok=True)
    p = lambda name: os.path.join(out_dir, name)  # noqa: E731
    # one mapping (native, the fastest) feeds both alignments
    run_cli([pt, pq, "-t", str(threads), "-m"], p("map4.paf"),
            env={"WFMASH_TPU_DEVICE_L1": "0"})
    base = [pt, pq, "-t", str(threads), "-i", p("map4.paf")]
    from wfmash_tpu.utils import perf

    perf.reset()
    t1 = run_cli(base, p("aln_1dev.paf"), env={"WFMASH_TPU_ALIGN_MESH": "0"})
    check(perf.get("align.sharded_calls") == 0, "1-device run sharded")
    t4 = run_cli(base, p("aln_4dev.paf"))
    n_sh = perf.get("align.sharded_calls")
    check(n_sh > 0, "the multi-device run made no sharded calls")
    same = open(p("aln_1dev.paf"), "rb").read() == \
        open(p("aln_4dev.paf"), "rb").read()
    n_rows, bad, cov = validate_alignment(p("aln_4dev.paf"), anc_b, der_b)
    log(f"[four] sharded_align devices={len(jax.devices())} "
        f"sharded_calls={n_sh:.0f} rows={n_rows} wall_1dev_s={t1:.2f}"
        f" wall_4dev_s={t4:.2f} paf_byte_identical={same} "
        f"replay_failures={bad} coverage={cov:.4f}")
    check(same, "4-device alignment PAF differs from 1 device")
    check(bad == 0, "sharded alignment CIGARs fail replay")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-device sharded paths")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--bp", type=int, default=12_000_000)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)
    try:
        import wfmash_tpu  # noqa: F401
    except ImportError:
        print("chip_smoke: the wfmash_tpu package is not importable; run "
              "this script from a checkout of the repository",
              file=sys.stderr)
        return 2
    from wfmash_tpu.utils import jaxcache

    jaxcache.enable()
    data_dir = os.path.join(REPO, ".smoke_data")
    out_dir = os.path.join(data_dir, "out")
    try:
        dev = phase_device()
        if args.four:
            phase_four(mapping_fixture(seed=args.seed),
                       make_inputs(data_dir, 3_000_000, args.seed),
                       args.threads, out_dir)
        else:
            from wfmash_tpu.align.wfa_np import Penalties
            from wfmash_tpu.params import AlignParams

            pen = _penalties(AlignParams())
            check(pen == Penalties(5, 8, 2, 24, 1), f"penalties {pen}")
            phase_segment_kernels(pen, seed=args.seed)
            phase_long_sweep(pen, seed=args.seed)
            phase_mapping_kernels(mapping_fixture(seed=args.seed))
            t0 = time.perf_counter()
            inputs = make_inputs(data_dir, args.bp, args.seed)
            log(f"[e2e] {args.bp / 1e6:.0f} Mb pair written in "
                f"{time.perf_counter() - t0:.1f}s (BGZF + .fai, seed "
                f"{args.seed})")
            phase_end_to_end(inputs, args.threads, out_dir)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
