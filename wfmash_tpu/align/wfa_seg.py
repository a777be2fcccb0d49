"""Segment solver: thousands of small WFA problems with full history and
an on-device backtrace, solved to complete CIGARs in one call.

This is the device half of anchored segmentation (align/segmented.py):
every anchored segment, boundary patch and structural-gap piece of the
align path is solved here. It plays the part of the reference's wflambda
segment machinery (reference: wflign.cpp:1061-1175 aligns 256-base
segments lazily under a guide wavefront; here the anchor chain has
already fixed the cuts, so segments are independent problems).

Two implementations of one solve, bit-identical to ``wfa_np.wfa_align``
(same recurrences, same tie-breaks) and to each other:

* ``kernel="cuda"`` — ``native/seg_wfa.cu``, called through
  ``jax.ffi``: one thread block per problem, one thread per diagonal
  lane, full history streamed to device memory as int16 rows, one
  thread walking the backtrace. Built with ``nvcc`` for ``sm_90a`` at
  first use. The default on a GPU.
* ``kernel="lax"`` — the same solve in plain ``jax.numpy``/``lax``,
  batched over every problem of a chunk: a ``while_loop`` over score
  levels writing a ``(5, smax, B, K)`` int16 history one level at a
  time, match runs found from precomputed per-diagonal eq bitstreams,
  and a per-problem backtrace advanced for all problems in lockstep.
  It is the plain reference the CUDA kernel is compared with, and what
  runs on the CPU.

Placement: each problem's query sits at column S and its target at
column P of padded rows, so the band centre (c = S - P) and ends-free
spans are data; one compiled shape per tier serves skewed and ends-free
problems alike. Problems that hit the score cap, or touch the band edge
without a certificate (score < the out-and-back gap cost of the margin),
are flagged and escalated by the caller.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from functools import partial
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from .wfa_np import Penalties

NEG_I = -(1 << 28)
NEG16 = -2048          # int16 history sentinel for "unreachable"

OP_EQ, OP_X, OP_I, OP_D = 0, 1, 2, 3
OP_SENTINEL = 15
OP_CHARS = "=XID"

M_, I1_, I2_, D1_, D2_ = 0, 1, 2, 3, 4


def default_kernel() -> str:
    """The CUDA kernel on a GPU, the plain-JAX solve everywhere else."""
    return "cuda" if jax.default_backend() == "gpu" else "lax"


def _ctz32(x):
    """Branchless count-trailing-zeros of a uint32 array (32 if zero)."""
    c = jnp.zeros(x.shape, jnp.int32)
    for sh, msk in ((16, 0xFFFF), (8, 0xFF), (4, 0xF), (2, 0x3), (1, 0x1)):
        z = (x & jnp.uint32(msk)) == 0
        c = c + jnp.where(z, sh, 0)
        x = jnp.where(z, x >> jnp.uint32(sh), x)
    return jnp.where(x == 0, 32, c)


# ---------------------------------------------------------------------------
# Plain-JAX solve
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("K",))
def _eq_bits(q, t, *, K):
    """(B, L) u8 query/target codes -> (B, L//32, K) uint32 eq bitstreams.

    Word w of diagonal lane l has bit j set iff
    q[32w+j] == t[32w+j - (l - K//2)]. Out-of-range target positions
    compare against 0xFF (mismatching every real code and both pads —
    the inputs are 4-bit codes <= 15)."""
    B, L = q.shape
    C = K // 2
    tp = jnp.pad(t, ((0, 0), (K, K)), constant_values=0xFF)
    shifts = (1 << jnp.arange(32, dtype=jnp.uint32)).astype(jnp.uint32)

    def body(carry, lane):
        start = K + C - lane
        tsl = jax.lax.dynamic_slice_in_dim(tp, start, L, axis=1)
        eq = (q == tsl).reshape(B, L // 32, 32).astype(jnp.uint32)
        words = jnp.sum(eq * shifts[None, None, :], axis=2, dtype=jnp.uint32)
        return carry, words

    _, stacked = jax.lax.scan(body, 0, jnp.arange(K))   # (K, B, L//32)
    return stacked.transpose(1, 2, 0)                    # (B, EQW, K)


def _seg_lax(par, eq, *, penalties: Penalties, K: int, smax: int,
             maxr: int):
    """(B, 16) int32 params + (B, EQW, K) eq bits -> (runs (B, maxr)
    int32, term (B, 16) int32). Same outputs as the CUDA kernel."""
    x, o1, e1, o2, e2 = (penalties.mismatch, penalties.gap_opening1,
                         penalties.gap_extension1, penalties.gap_opening2,
                         penalties.gap_extension2)
    B, eqw = par.shape[0], eq.shape[1]
    NEG = jnp.int32(NEG_I)
    qlen, tlen, S_, c_, tb_, qb_, te_, qe_, cap = (
        par[:, j:j + 1] for j in range(9))
    lane = jnp.arange(K, dtype=jnp.int32)[None, :]
    kvec = lane - K // 2
    rows = jnp.arange(B)

    def to16(v):
        return jnp.where(v <= NEG_I // 2, NEG16, v).astype(jnp.int16)

    def from16(v):
        v = v.astype(jnp.int32)
        return jnp.where(v == NEG16, NEG, v)

    def accept_info(m):
        """(done, lane*, h*) with lane* = smallest accepting diagonal."""
        v = m - kvec
        ok = m > NEG
        c1 = ok & (m == qlen) & (tlen - v <= te_) & (v >= 0)
        c2 = ok & (v == tlen) & (qlen - m <= qe_) & (m >= 0)
        lane_a = jnp.min(jnp.where(c1 | c2, lane, K), axis=1)
        done = lane_a < K
        h_a = jnp.take_along_axis(
            m, jnp.minimum(lane_a, K - 1)[:, None], axis=1)[:, 0]
        return done, lane_a, jnp.where(done, h_a, 0)

    def ext_step(h, more):
        """One 64-bit window of eq bits from bit h, for lanes in more."""
        idx = jnp.where(more, h, 0)
        wi = idx >> 5
        bo = (idx & 31).astype(jnp.uint32)

        def word(j):
            w = wi + j
            g = jnp.take_along_axis(
                eq, jnp.clip(w, 0, eqw - 1)[:, None, :], axis=1)[:, 0, :]
            return jnp.where(w < eqw, g, jnp.uint32(0))

        a0, a1, a2 = word(0), word(1), word(2)
        sh = jnp.uint32(32) - bo
        al = jnp.where(bo == 0, a0, (a0 >> bo) | (a1 << sh))
        ah = jnp.where(bo == 0, a1, (a1 >> bo) | (a2 << sh))
        r0 = _ctz32(~al)
        run = jnp.where(r0 == 32, 32 + _ctz32(~ah), r0)
        h2 = jnp.where(more, h + run, h)
        return h2, more & (run == 64) & (h2 < qlen)

    def extend(m_off, live):
        h, more = ext_step(m_off, (m_off > NEG) & live)
        h, _ = jax.lax.while_loop(lambda c: jnp.any(c[1]),
                                  lambda c: ext_step(*c), (h, more))
        v = h - kvec
        over = jnp.maximum(jnp.maximum(h - qlen, v - tlen), 0)
        return jnp.where(h > NEG, h - over, h)

    def sr(a):   # value at k-1
        return jnp.concatenate([jnp.full((B, 1), NEG), a[:, :-1]], axis=1)

    def sl(a):   # value at k+1
        return jnp.concatenate([a[:, 1:], jnp.full((B, 1), NEG)], axis=1)

    # ---- score 0: seeds in true diagonals (kernel diagonal - c) ----------
    ktrue = kvec - c_
    seed = jnp.where((ktrue <= 0) & (-ktrue <= tb_), S_, NEG)
    seed = jnp.where((ktrue > 0) & (ktrue <= qb_), S_ + ktrue, seed)
    m0 = extend(seed, jnp.ones((B, 1), bool))
    hist = jnp.full((5, smax, B, K), NEG16, jnp.int16)
    hist = hist.at[M_, 0].set(to16(m0))
    done0, lane0, h0 = accept_info(m0)

    def hread(hist, state, s):
        row = jax.lax.dynamic_index_in_dim(hist[state], jnp.maximum(s, 0),
                                           axis=0, keepdims=False)
        return jnp.where(s >= 0, from16(row), NEG)

    def fcond(c):
        s, _, _, stop = c[:4]
        return (s < smax) & jnp.any(~stop)

    def fbody(c):
        s, hist, done, stop, s_fin, lane_a, h_a, edge, swept = c
        live = ~stop
        m_x = hread(hist, M_, s - x)
        m_o1 = hread(hist, M_, s - o1 - e1)
        m_o2 = hread(hist, M_, s - o2 - e2)
        i1b = jnp.maximum(sr(m_o1), sr(hread(hist, I1_, s - e1)))
        i2b = jnp.maximum(sr(m_o2), sr(hread(hist, I2_, s - e2)))
        i1 = jnp.where(i1b > NEG, i1b + 1, NEG)
        i2 = jnp.where(i2b > NEG, i2b + 1, NEG)
        d1 = jnp.maximum(sl(m_o1), sl(hread(hist, D1_, s - e1)))
        d2 = jnp.maximum(sl(m_o2), sl(hread(hist, D2_, s - e2)))
        mm = jnp.where(m_x > NEG, m_x + 1, NEG)
        m_off = jnp.maximum(
            jnp.maximum(jnp.maximum(mm, i1), jnp.maximum(i2, d1)), d2)
        v = m_off - kvec
        okb = (m_off >= 0) & (m_off <= qlen) & (v >= 0) & (v <= tlen)
        m_ext = extend(jnp.where(okb, m_off, NEG), live[:, None])
        # band-edge contact counts only while a problem still searches
        at_edge = jnp.any(((lane == 0) | (lane == K - 1)) & (m_ext > NEG),
                          axis=1)
        edge = edge | (live & at_edge)
        lvl = jnp.stack([to16(m_ext), to16(i1), to16(i2), to16(d1),
                         to16(d2)])[:, None]
        hist = jax.lax.dynamic_update_slice(hist, lvl, (0, s, 0, 0))
        dn, la, ha = accept_info(m_ext)
        newly = live & dn
        gave = live & ~dn & (cap[:, 0] > 0) & (s >= cap[:, 0])
        return (s + 1, hist, done | newly, stop | newly | gave,
                jnp.where(newly, s, s_fin), jnp.where(newly, la, lane_a),
                jnp.where(newly, ha, h_a), edge,
                jnp.where(live, s + 1, swept))

    zeros = jnp.zeros((B,), jnp.int32)
    _, hist, done, _, s_fin, lane_a, h_a, edge, swept = jax.lax.while_loop(
        fcond, fbody,
        (jnp.int32(1), hist, done0, done0, zeros,
         jnp.where(done0, lane0, 0), h0, jnp.zeros((B,), bool),
         jnp.ones((B,), jnp.int32)))

    # ---- backtrace: every problem walks its own levels, in lockstep ------
    flat = hist.reshape(-1)

    def hget(state, s, k):
        ok = (s >= 0) & (k >= 0) & (k < K)
        i = ((state * smax + jnp.clip(s, 0, smax - 1)) * B + rows) * K \
            + jnp.clip(k, 0, K - 1)
        return jnp.where(ok, from16(flat[i]), NEG)

    def emit(runs, cur, mask, op, n):
        """Append run (op, n) where mask, RLE-merged with the entry
        written before it."""
        m2 = mask & (n > 0)
        nxt = cur + 1
        prev = runs[rows, jnp.clip(nxt, 0, maxr - 1)]
        same = m2 & (nxt >= 0) & (nxt < maxr) & ((prev >> 13) == op)
        new = m2 & ~same
        n = jnp.broadcast_to(n, (B,))
        runs = runs.at[rows, jnp.where(same, nxt, maxr)].add(n, mode="drop")
        runs = runs.at[rows, jnp.where(new & (cur >= 0), cur, maxr)].set(
            (op << 13) | n, mode="drop")
        return runs, cur - new.astype(jnp.int32)

    Qc, Tc, S1, c1 = qlen[:, 0], tlen[:, 0], S_[:, 0], c_[:, 0]
    runs = jnp.full((B, maxr), OP_SENTINEL << 13, jnp.int32)
    cur = jnp.full((B,), maxr - 1, jnp.int32)
    # trailing free gap: the accepted cell may sit short of the corner
    v_acc = h_a - (lane_a - K // 2)
    trail_d = done & (h_a == Qc) & (v_acc < Tc)
    runs, cur = emit(runs, cur, trail_d, OP_D, Tc - v_acc)
    trail_i = done & ~trail_d & (v_acc == Tc) & (h_a < Qc)
    runs, cur = emit(runs, cur, trail_i, OP_I, Qc - h_a)

    def bbody(c):
        runs, cur, s, k, h, st, act, ok = c
        # -- M cell: extension run, then mismatch or the gap it came from
        is_m = act & (st == M_)
        seed = is_m & (s == 0)
        mres = is_m & (s > 0)
        cx = hget(M_, s - x, k)
        cx = jnp.where(cx > NEG, cx + 1, NEG)
        ci1, ci2 = hget(I1_, s, k), hget(I2_, s, k)
        cd1, cd2 = hget(D1_, s, k), hget(D2_, s, k)
        pre = jnp.maximum(jnp.maximum(jnp.maximum(cx, ci1),
                                      jnp.maximum(ci2, cd1)), cd2)
        bad = mres & (pre <= NEG)
        mres = mres & ~bad
        runs, cur = emit(runs, cur, mres, OP_EQ, h - pre)
        wx = mres & (cx == pre)
        wi1 = mres & ~wx & (ci1 == pre)
        wi2 = mres & ~wx & ~wi1 & (ci2 == pre)
        wd1 = mres & ~wx & ~wi1 & ~wi2 & (cd1 == pre)
        wd2 = mres & ~wx & ~wi1 & ~wi2 & ~wd1
        runs, cur = emit(runs, cur, wx, OP_X, 1)
        s = jnp.where(wx, s - x, s)
        h = jnp.where(wx, pre - 1, jnp.where(mres, pre, h))
        st = jnp.where(wi1, I1_, jnp.where(wi2, I2_, jnp.where(
            wd1, D1_, jnp.where(wd2, D2_, st))))
        # leading: extension run down to the seed, then the free begin gap
        kt_s = (k - K // 2) - c1
        runs, cur = emit(runs, cur, seed, OP_EQ,
                         h - S1 - jnp.maximum(kt_s, 0))
        runs, cur = emit(runs, cur, seed & (kt_s < 0), OP_D, -kt_s)
        runs, cur = emit(runs, cur, seed & (kt_s > 0), OP_I, kt_s)
        act = act & ~seed & ~bad
        ok = ok & ~bad
        # -- gap cell at the same level: open (from M) before extend ------
        g = act & (st != M_)
        ins = (st == I1_) | (st == I2_)
        first = (st == I1_) | (st == D1_)
        o = jnp.where(first, o1, o2)
        e = jnp.where(first, e1, e2)
        kd = jnp.where(ins, k - 1, k + 1)
        open_ = hget(M_, s - o - e, kd)
        ext = hget(st, s - e, kd)
        runs, cur = emit(runs, cur, g & ins, OP_I, 1)
        runs, cur = emit(runs, cur, g & ~ins, OP_D, 1)
        want = jnp.where(ins, h - 1, h)
        use_open = g & (open_ > NEG) & (open_ == want)
        use_ext = g & ~use_open & (ext > NEG) & (ext == want)
        moved = use_open | use_ext
        s = jnp.where(use_open, s - o - e, jnp.where(use_ext, s - e, s))
        h = jnp.where(moved, want, h)
        k = jnp.where(moved, kd, k)
        st = jnp.where(use_open, M_, st)
        act = act & ~(g & ~moved)
        ok = ok & ~(g & ~moved)
        return runs, cur, s, k, h, st, act, ok

    runs, cur, *_, act, ok = jax.lax.while_loop(
        lambda c: jnp.any(c[6]), bbody,
        (runs, cur, s_fin, lane_a, h_a, jnp.zeros((B,), jnp.int32), done,
         jnp.ones((B,), bool)))
    one = jnp.int32(1)
    term = jnp.stack(
        [done.astype(jnp.int32), s_fin, one - done.astype(jnp.int32),
         edge.astype(jnp.int32), cur, (ok & ~act).astype(jnp.int32),
         lane_a, h_a, swept] + [zeros] * 7, axis=1)
    return runs, term


# ---------------------------------------------------------------------------
# CUDA kernel (native/seg_wfa.cu) through jax.ffi
# ---------------------------------------------------------------------------

_NATIVE = Path(__file__).resolve().parent.parent / "native"
_CU_SRC = _NATIVE / "seg_wfa.cu"
_CU_LIB = _NATIVE / "_seg_wfa_cuda.so"
_CU_TARGET = "wfmash_seg_wfa"
_cu_lock = threading.Lock()
_cu_registered = False


def _nvcc() -> str:
    got = shutil.which("nvcc")
    if got:
        return got
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA segment kernel needs the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_cuda_kernel() -> Path:
    """Compile native/seg_wfa.cu for sm_90a unless an up-to-date build is
    present. Returns the library path; raises with nvcc's output on a
    failed build."""
    if (_CU_LIB.exists()
            and _CU_LIB.stat().st_mtime >= _CU_SRC.stat().st_mtime):
        return _CU_LIB
    tmp = _CU_LIB.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", str(tmp), str(_CU_SRC)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed on %s:\n%s" % (_CU_SRC.name,
                                                        r.stderr[-4000:]))
    os.replace(tmp, _CU_LIB)
    return _CU_LIB


def _register_cuda_target() -> None:
    global _cu_registered
    with _cu_lock:
        if _cu_registered:
            return
        import ctypes

        lib = ctypes.cdll.LoadLibrary(str(build_cuda_kernel()))
        jax.ffi.register_ffi_target(
            _CU_TARGET, jax.ffi.pycapsule(lib.SegWfa), platform="CUDA")
        _cu_registered = True


def _seg_cuda(buf, *, penalties: Penalties, K: int, smax: int, maxr: int):
    _register_cuda_target()
    B = buf.shape[0]
    call = jax.ffi.ffi_call(_CU_TARGET, (
        jax.ShapeDtypeStruct((B, maxr), jnp.int32),
        jax.ShapeDtypeStruct((B, 16), jnp.int32),
        # full history: scratch for the backtrace, dropped after the call
        jax.ShapeDtypeStruct((B, 5 * smax * K), jnp.int16)))
    i32 = np.int32
    runs, term, _ = call(
        buf, K=i32(K), smax=i32(smax), maxr=i32(maxr),
        x=i32(penalties.mismatch), o1=i32(penalties.gap_opening1),
        e1=i32(penalties.gap_extension1), o2=i32(penalties.gap_opening2),
        e2=i32(penalties.gap_extension2))
    return runs, term


# compact-runs width: the epilogue gathers this many int16 entries from
# each row's write cursor. Rows needing more (used > RUNS_CAP, rare
# deep-divergence CIGARs) are read from the full int32 runs buffer,
# fetched only then.
RUNS_CAP = 128


def _run_seg_impl(buf, *, penalties, K, smax, maxr, kernel):
    """(B, L//2 + L//2 + 64) u8 chunk buffer (nibble-packed query rows |
    nibble-packed target rows | 16 little-endian int32 params per row)
    -> (runs_full i32 (B, maxr), out16 i16 (B, 16 + RUNS_CAP): term
    columns then compacted runs). Traceable body (jitted directly, or
    per device inside shard_map)."""
    B = buf.shape[0]
    L = buf.shape[1] - 64
    if kernel == "cuda":
        runs, term = _seg_cuda(buf, penalties=penalties, K=K, smax=smax,
                               maxr=maxr)
    else:
        pb = buf[:, L:].reshape(B, 16, 4).astype(jnp.uint32)
        par = jax.lax.bitcast_convert_type(
            pb[..., 0] | (pb[..., 1] << 8) | (pb[..., 2] << 16)
            | (pb[..., 3] << 24), jnp.int32)

        def unpack(x):
            return jnp.stack([x & jnp.uint8(15), x >> jnp.uint8(4)],
                             axis=-1).reshape(B, L)

        eq = _eq_bits(unpack(buf[:, :L // 2]), unpack(buf[:, L // 2:L]),
                      K=K)
        runs, term = _seg_lax(par, eq, penalties=penalties, K=K,
                              smax=smax, maxr=maxr)
    cap = min(maxr, RUNS_CAP)
    idx = jnp.minimum(term[:, 4:5] + 1 + jnp.arange(cap), maxr - 1)
    runs_c = jnp.take_along_axis(runs, idx, axis=-1).astype(jnp.int16)
    # one readback array: term columns (all fit int16 — scores <= smax
    # <= 2048, cursors <= maxr-1 <= 4223) then the compact runs
    out16 = jnp.concatenate([term.astype(jnp.int16), runs_c], axis=-1)
    return runs, out16


_run_seg = partial(jax.jit, static_argnames=(
    "penalties", "K", "smax", "maxr", "kernel"))(_run_seg_impl)


@partial(jax.jit, static_argnames=("mesh", "penalties", "K", "smax",
                                   "maxr", "kernel"))
def _run_seg_sharded(buf, *, mesh, penalties, K, smax, maxr, kernel):
    """Segment batch sharded over the mesh: problems split across
    devices — the record-parallel align loop of the reference
    (computeAlignments.hpp:391-438) as spatial parallelism. No
    cross-device communication: results concatenate in order, so the
    merged PAF is byte-identical to one device."""
    from jax.sharding import PartitionSpec as P

    spec = P(mesh.axis_names[0])

    def local(buf):
        return _run_seg_impl(buf, penalties=penalties, K=K, smax=smax,
                             maxr=maxr, kernel=kernel)

    return jax.shard_map(local, mesh=mesh, in_specs=(spec,),
                         out_specs=(spec, spec), check_vma=False)(buf)


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


def _job_parts(job):
    """Normalize a job tuple: (q, t) or (q, t, ends_free) -> (q, t, ef)."""
    q, t = job[0], job[1]
    ef = job[2] if len(job) > 2 else None
    return q, t, ef


# 4-bit symbol codes for the packed upload. The align path only sees
# normalized sequences (sketch/kmers.py:normalize maps everything to
# uppercase ACGTN), plus the two pad sentinels. Codes 5-13 are spare for
# the dynamic per-chunk remap (any injective byte->code map preserves
# the match semantics — the solve only tests equality).
_SYM_LUT = np.full(256, 0xFF, np.uint8)
for _i, _b in enumerate(b"ACGTN"):
    _SYM_LUT[_b] = _i
_SYM_LUT[0x01] = 14   # query pad (never matches target pad 15)
_SYM_LUT[0x02] = 15   # target pad


def _place4(codes_flat, lens, starts, B, L, pad_code):
    """Place nj concatenated code sequences into (B, L) rows (sequence j
    at column starts[j], pad elsewhere), nibble-packed to (B, L//2) u8."""
    nj = len(lens)
    out = np.full((B, L), pad_code, np.uint8)
    if nj:
        off = np.zeros(nj, np.int64)
        off[1:] = np.cumsum(lens[:-1])
        lens_a = np.asarray(lens, np.int64)
        ar = np.arange(L, dtype=np.int64)[None, :]
        sv = np.asarray(starts, np.int64)[:, None]
        pos = off[:, None] + (ar - sv)
        valid = (ar >= sv) & (ar < sv + lens_a[:, None])
        hi = max(len(codes_flat) - 1, 0)
        src = codes_flat[np.clip(pos, 0, hi)] if len(codes_flat) else \
            np.zeros((nj, L), np.uint8)
        out[:nj] = np.where(valid, src, pad_code)
    return out[:, 0::2] | (out[:, 1::2] << 4)


_BAND_MARGIN = 16    # lanes kept free of the diagonal interest range


class SegmentSolver:
    """Batched device solver for small WFA problems (end-to-end AND
    ends-free).

    solve(jobs) -> list of RLE CIGARs [(n, op)] (op in '=XID'), or None
    for problems the solver cannot certify (too long, diagonal interest
    range wider than the band, score cap hit, band-edge contact above
    the certificate bound, or an inconsistent backtrace — the caller
    escalates those to the exact engine).

    jobs are (q, t) or (q, t, EndsFree). The band is re-centered per
    problem by PLACING the sequences at offsets inside the padded rows
    (query at S, target at P, center = S - P): the recurrences are
    center-agnostic, so skewed/ends-free problems cost no extra program
    shapes. Calls are padded to a power-of-two row count (at least 8,
    at most max_call), so each tier compiles a handful of shapes.
    """

    def __init__(self, penalties: Penalties, K: int = 256, smax: int = 256,
                 lseg: int = 512, max_call: int = 1024, mesh=None,
                 kernel: str | None = None):
        self.p = penalties
        self.kernel = kernel or default_kernel()
        self.K = K
        self.smax = smax
        self.lseg = lseg
        self.maxr = 2 * smax + 128
        self.max_call = max_call
        self.e_min = min(penalties.gap_extension1, penalties.gap_extension2)
        # optional jax.sharding.Mesh: problems shard across its first
        # axis (see _run_seg_sharded)
        self.mesh = None
        if mesh is not None:
            n_dev = int(mesh.shape[mesh.axis_names[0]])
            if n_dev > 1 and max_call % n_dev == 0:
                self.mesh = mesh

    def _rows(self, nj: int) -> int:
        """Padded row count of a call with nj problems."""
        B = min(self.max_call, 1 << max(3, (max(nj, 1) - 1).bit_length()))
        if self.mesh is not None:
            n_dev = int(self.mesh.shape[self.mesh.axis_names[0]])
            B = -(-B // n_dev) * n_dev
        return B

    def _envelope(self, m: int, n: int, ef):
        """Fit check. Returns (S, P, tb, qb, te, qe, cert_bound,
        always_cert) or None.

        Seed hull = score-0 diagonals [-tb, qb]; accept hull = accepting
        diagonals [m-n-qe, m-n+te] (wfa_np:140-159). The band need NOT
        cover both: diagonals change only via I/D ops, so

        * both hulls in band with margin M      -> any out-of-band path
          leaves AND returns: cost >= 2*gap_cost(M); certificate gated
          on the band-edge contact flag;
        * one hull truncated, the other (the ANCHOR) in band with
          margin M -> every path starts (seeds) or ends (accepts) in
          the anchor hull, so touching an out-of-band diagonal costs
          >= gap_cost(M); certificate applied UNCONDITIONALLY (an
          out-of-band seed/accept path never shows edge contact);
        * both hulls truncated -> reject (an out-of-band seed can pair
          with an out-of-band accept invisibly, e.g. wide structural
          gaps — no sound certificate).

        This is what lets arbitrarily-wide boundary-patch jobs (free
        begin spans = whole piece) run on device: the accept hull is a
        corner diagonal, the giant seed hull is truncated soundly."""
        if ef is None:
            tb = qb = te = qe = 0
        else:
            tb = min(ef.target_begin, n)
            qb = min(ef.query_begin, m)
            te = ef.target_end
            qe = ef.query_end
        C = self.K // 2
        M = _BAND_MARGIN
        s_lo, s_hi = -tb, qb
        a_lo, a_hi = m - n - qe, m - n + te
        lo, hi = min(s_lo, a_lo), max(s_hi, a_hi)
        seeds_fit = s_hi - s_lo < self.K - 2 * M
        accepts_fit = a_hi - a_lo < self.K - 2 * M
        if hi - lo < self.K - 2 * M:
            # combined hull fits: classic out-and-back certificate
            cc = (lo + hi) // 2
            margin = C - max(hi - cc, cc - lo)
            cert_bound = 2 * self.p.gap_cost(margin)
            always = False
        elif accepts_fit:
            # seeds truncated; anchor = accept hull, centered exactly
            # (max margin -> max certificate; in-band seeds near the
            # anchor are the ones real patch paths start from)
            cc = (a_lo + a_hi) // 2
            margin = C - max(a_hi - cc, cc - a_lo)
            cert_bound = self.p.gap_cost(margin)
            always = True
        elif seeds_fit:
            # accepts truncated; anchor = seed hull
            cc = (s_lo + s_hi) // 2
            margin = C - max(s_hi - cc, cc - s_lo)
            cert_bound = self.p.gap_cost(margin)
            always = True
        else:
            return None
        S, P = max(0, -cc), max(0, cc)
        if S + m >= self.lseg or P + n >= self.lseg:
            return None
        return (S, P, tb, qb, te, qe, cert_bound, always)

    def accepts(self, qlen: int, tlen: int, ends_free=None) -> bool:
        return self._envelope(qlen, tlen, ends_free) is not None

    def solve(self, jobs, certify: bool = True, status: list | None = None,
              max_scores: list | None = None,
              uncertified: list | None = None):
        """status (optional, filled per job): "ok", "envelope" (outside
        the band/length envelope), "scorecap" (forward sweep exhausted
        the score budget — the true score EXCEEDS min(cap, smax)),
        "uncert" (banded result above the certificate bound; only with
        certify=True), "badbt".
        certify=False returns uncertified banded CIGARs: replayable,
        score-valid alignments that may not be globally optimal — sound
        for budget checks (inversion tries), NOT for the main path.
        max_scores: optional per-job score caps — the sweep gives a job
        up once its cap is reached (cheap refutation).
        uncertified (optional list): filled with the banded CIGAR for
        "uncert" jobs (replayable, score-valid, possibly suboptimal) so
        callers can accept them as a ledgered approximation."""
        results: list = [None] * len(jobs)
        st = ["envelope"] * len(jobs)
        todo = []
        for i, job in enumerate(jobs):
            q, t, ef = _job_parts(job)
            m, n = len(q), len(t)
            if m == 0 and n == 0:
                results[i] = []
                st[i] = "ok"
            elif (m == 0 or n == 0) and ef is None:
                ops = []
                if n:
                    ops.append((n, "D"))
                if m:
                    ops.append((m, "I"))
                results[i] = ops
                st[i] = "ok"
            elif m and n and self.accepts(m, n, ef):
                todo.append(i)
        # sort by size so a chunk's problems finish close together
        todo.sort(key=lambda i: max(len(jobs[i][0]), len(jobs[i][1])))
        unc: list = [None] * len(jobs)
        # dispatch every chunk (asynchronous), then collect in order
        import time

        from ..utils import perf

        t0 = time.monotonic()
        disps = []
        for c0 in range(0, len(todo), self.max_call):
            chunk = todo[c0:c0 + self.max_call]
            disps.append(self._dispatch_chunk(chunk, jobs, max_scores))
        for disp in disps:
            self._collect_chunk(disp, results, st, certify, unc)
        if disps:
            perf.add("align.device_s", time.monotonic() - t0)
            perf.add("align.device_calls", len(disps))
        if status is not None:
            status[:] = st
        if uncertified is not None:
            uncertified[:] = unc
        return results

    def _dispatch_chunk(self, idxs, jobs, max_scores):
        """Pack one chunk and launch it (async). Returns the collect
        state: device arrays + per-job certificate metadata."""
        packed = self.pack_chunk(idxs, jobs, max_scores)
        if packed is None:
            return dict(idxs=idxs, give_up=True)
        buf, cert_b, cert_always = packed
        if self.mesh is None:
            run_fn = _run_seg
        else:
            from ..utils import perf

            perf.add("align.sharded_calls", 1)
            run_fn = partial(_run_seg_sharded, mesh=self.mesh)
        runs_full, out16 = run_fn(
            jnp.asarray(buf), penalties=self.p, K=self.K, smax=self.smax,
            maxr=self.maxr, kernel=self.kernel)
        return dict(idxs=idxs, runs_full=runs_full, out16=out16,
                    cert_b=cert_b, cert_always=cert_always)

    def pack_chunk(self, idxs, jobs, max_scores=None):
        """One call's input: (buf (B, lseg + 64) u8, certificate bounds,
        always-certify flags), or None for a chunk with more than 14
        distinct symbols."""
        L = self.lseg
        nj = len(idxs)
        B = self._rows(nj)
        par = np.zeros((B, 16), np.int32)
        cert_b = np.zeros(B, np.int64)
        cert_always = np.zeros(B, bool)
        qparts: list = []
        tparts: list = []
        for j, i in enumerate(idxs):
            q, t, ef = _job_parts(jobs[i])
            m, n = len(q), len(t)
            S, P, tb, qb, te, qe, cbound, calways = self._envelope(m, n, ef)
            qparts.append(bytes(q))
            tparts.append(bytes(t))
            par[j, 0] = S + m
            par[j, 1] = P + n
            par[j, 2] = S
            par[j, 3] = S - P
            par[j, 4] = tb
            par[j, 5] = qb
            par[j, 6] = te
            par[j, 7] = qe
            if max_scores is not None and max_scores[i] is not None:
                par[j, 8] = min(int(max_scores[i]), self.smax)
            cert_b[j] = cbound
            cert_always[j] = calways
        # 4-bit coded upload; normalize() upstream guarantees ACGTN, but
        # guard: unmapped bytes get a dynamic per-chunk remap
        # (equality-preserving), and a >14-symbol chunk (impossible for
        # DNA) falls back to the exact engine via "envelope" status
        lut = _SYM_LUT
        flat_q = np.frombuffer(b"".join(qparts), np.uint8)
        flat_t = np.frombuffer(b"".join(tparts), np.uint8)
        cq, ct = lut[flat_q], lut[flat_t]
        if nj and (cq.max(initial=0) == 0xFF or ct.max(initial=0) == 0xFF):
            present = np.nonzero(
                np.bincount(flat_q, minlength=256)
                + np.bincount(flat_t, minlength=256))[0]
            if len(present) > 14:
                return None
            lut = np.full(256, 0xFF, np.uint8)
            for ci, b in enumerate(present):
                lut[b] = ci
            cq, ct = lut[flat_q], lut[flat_t]
        q4 = _place4(cq, [len(x) for x in qparts], par[:nj, 2], B, L, 14)
        t4 = _place4(ct, [len(x) for x in tparts],
                     par[:nj, 2] - par[:nj, 3], B, L, 15)
        # ONE fused upload: query nibbles | target nibbles | params as
        # little-endian bytes
        buf = np.concatenate(
            [q4, t4, par.astype("<i4").view(np.uint8).reshape(B, 64)],
            axis=1)
        return buf, cert_b, cert_always

    def _collect_chunk(self, disp, results, st, certify, unc):
        from ..utils import perf

        idxs = disp["idxs"]
        if disp.get("give_up"):
            return                      # statuses stay "envelope"
        maxr = self.maxr
        cap = min(maxr, RUNS_CAP)
        out16 = np.asarray(disp["out16"])
        term = out16[:, :16]
        runs_c = out16[:, 16:]
        cert_b, cert_always = disp["cert_b"], disp["cert_always"]
        nj_rows = len(idxs)
        # swept cells: per problem, levels x K lanes x 5 states
        levels = term[:nj_rows, 8].astype(np.int64)
        perf.add("align.device_cells", int(levels.sum()) * self.K * 5)
        perf.add("align.seg_jobs.k%d_s%d" % (self.K, self.smax), nj_rows)
        self.last_levels = levels
        cur = term[:, 4].astype(np.int64)
        used = (maxr - 1) - cur
        runs_np = None
        if (used[:nj_rows] > cap).any():
            # rare overflow (deep-divergence CIGARs): one full readback
            runs_np = np.asarray(disp["runs_full"])
        # flat-prefix decode: gather ONLY the used entries of the rows in
        # this chunk into one flat array, tolist() once, and build each
        # row's ops with a zip over slices
        used_c = np.minimum(used[:nj_rows], cap)
        tot = int(used_c.sum())
        row_off = np.zeros(nj_rows + 1, np.int64)
        np.cumsum(used_c, out=row_off[1:])
        rr = np.repeat(np.arange(nj_rows), used_c)
        cc = np.arange(tot, dtype=np.int64) - np.repeat(row_off[:-1], used_c)
        vals = runs_c[rr, cc].astype(np.int32)
        n_flat = (vals & 0x1FFF).tolist()
        o_flat = [OP_CHARS[o] for o in (vals >> 13).tolist()]
        off_l = row_off.tolist()
        t0_l = term[:nj_rows, 0].tolist()
        t1_l = term[:nj_rows, 1].tolist()
        t3_l = term[:nj_rows, 3].tolist()
        t5_l = term[:nj_rows, 5].tolist()
        used_l = used[:nj_rows].tolist()
        opc = OP_CHARS
        for j, i in enumerate(idxs):
            if not t0_l[j]:
                st[i] = "scorecap"
                continue
            if not t5_l[j]:
                st[i] = "badbt"
                continue
            score = t1_l[j]
            u = used_l[j]
            if u > cap:
                valsf = runs_np[j, cur[j] + 1:maxr].astype(np.int32)
                ops = list(zip((valsf & 0x1FFF).tolist(),
                               (opc[o] for o in (valsf >> 13).tolist())))
            else:
                a, b = off_l[j], off_l[j + 1]
                ops = list(zip(n_flat[a:b], o_flat[a:b]))
            if certify and (t3_l[j] or cert_always[j]):
                # the certificate bound (see _envelope): a banded score
                # strictly below it proves no out-of-band path can win.
                # Checked on band-edge contact, or unconditionally when
                # the seed/accept hull was truncated to fit the band.
                if score >= int(cert_b[j]):
                    st[i] = "uncert"
                    # banded result, caller's choice: (ops, banded
                    # score, certificate bound) — a score far above the
                    # bound signals an out-of-band true path (e.g. a
                    # repeat-period diagonal shift), not mild banding
                    unc[i] = (ops, score, int(cert_b[j]))
                    continue
            st[i] = "ok"
            results[i] = ops


class TieredSegmentSolver:
    """Five solver shapes behind one solve():

    * tier 1 — K=128, smax=128, lseg=512: the bulk of anchored segments
      (~256 bp, near-diagonal, low divergence);
    * tier 2 — K=256, smax=384, lseg=512: wider band and score budget
      for tier-1 rejections (divergent, clipped, skewed);
    * tier 3 — K=512, smax=768, lseg=2048: mid-size pieces (0.5-2 kb),
      boundary patches, and structural-gap ends-free jobs;
    * tier 4 — K=1024, smax=512, lseg=4224: the deep-patch tier; K=1024
      doubles the certificate bound (gap_cost(512) = 536) and lseg=4224
      admits full-size boundary-patch erodes (<= 4096 a side,
      wflign.cpp:240-418);
    * tier 5 — K=256, smax=2048, lseg=2048: deep divergence, for
      unanchorable <= 1 kb pieces (no 13-mer chain at 25-40%
      divergence).

    Jobs cascade t1 -> ... -> t5 on BOTH envelope rejection and solver
    failure (score cap / uncertified band edge); a job failing all
    returns None for the caller's exact-engine escalation. max_call
    bounds one call's history (max_call x 5 x smax x K int16): 0.7 GB
    for tier 1, 1.0-2.7 GB for the deeper tiers.
    """

    def __init__(self, penalties: Penalties, mesh=None,
                 kernel: str | None = None):
        kernel = kernel or default_kernel()
        self.p = penalties
        self.kernel = kernel

        def tier(K, smax, lseg, max_call):
            return SegmentSolver(penalties, K=K, smax=smax, lseg=lseg,
                                 max_call=max_call, mesh=mesh,
                                 kernel=kernel)

        self.t1 = tier(128, 128, 512, 4096)
        self.t2 = tier(256, 384, 512, 1024)
        self.t3 = tier(512, 768, 2048, 512)
        self.t4 = tier(1024, 512, 4224, 256)
        self.t5 = tier(256, 2048, 2048, 512)
        self.tiers = (self.t1, self.t2, self.t3, self.t4, self.t5)

    def accepts(self, qlen: int, tlen: int, ends_free=None) -> bool:
        return any(t.accepts(qlen, tlen, ends_free) for t in self.tiers)

    def solve(self, jobs, certify: bool = True, status: list | None = None,
              max_scores: list | None = None,
              uncertified: list | None = None):
        """Like SegmentSolver.solve, but status entries are
        (code, smax_of_deepest_attempting_tier) tuples."""
        res: list = [None] * len(jobs)
        st: list = [("envelope", 0)] * len(jobs)
        unc_all: list = [None] * len(jobs)
        pending = list(range(len(jobs)))
        for tier in self.tiers:
            if not pending:
                break
            idx = [i for i in pending
                   if tier.accepts(len(jobs[i][0]), len(jobs[i][1]),
                                   _job_parts(jobs[i])[2])
                   or not jobs[i][0] or not jobs[i][1]]
            if idx:
                refuted = self._run_tier(tier, idx, jobs, certify,
                                         max_scores, res, st, unc_all)
                pending = [i for i in pending
                           if res[i] is None and i not in refuted]
            else:
                pending = [i for i in pending if res[i] is None]
        if status is not None:
            status[:] = st
        if uncertified is not None:
            uncertified[:] = unc_all
        return res

    def _run_tier(self, tier, idx, jobs, certify, max_scores, res, st,
                  unc_all):
        """One tier pass over job indices idx; fills res/st/unc_all and
        returns the set of refuted indices (score cap proven)."""
        tst: list = []
        tunc: list = []
        got = tier.solve(
            [jobs[i] for i in idx], certify=certify, status=tst,
            max_scores=None if max_scores is None else
            [max_scores[i] for i in idx], uncertified=tunc)
        refuted = set()
        for i, o, s, u in zip(idx, got, tst, tunc):
            res[i] = o
            if u is not None:
                unc_all[i] = u   # deepest tier's banded result
            if s != "envelope":
                # deepest tier that attempted it, with its score
                # budget (a "scorecap" proves score > that smax)
                st[i] = (s, tier.smax)
            if (s == "scorecap" and max_scores is not None
                    and max_scores[i] is not None
                    and max_scores[i] <= tier.smax):
                # score > cap proven — no deeper tier can help
                refuted.add(i)
        return refuted

    def stream(self, certify: bool = True):
        """Streaming solve: a _StreamSolve whose add() feeds jobs from
        the planning thread while run() (a worker thread) dispatches
        tier-1 chunks as they fill, then cascades the remainder through
        the deeper tiers. Per-job results are bit-identical to solve()
        (a job's result never depends on its chunk's other members)."""
        return _StreamSolve(self, certify)


class _StreamSolve:
    """Producer/consumer wrapper around TieredSegmentSolver (see
    TieredSegmentSolver.stream). add() and close() are called by the
    producing (planning) thread; run() is the consuming worker."""

    def __init__(self, solver: TieredSegmentSolver, certify: bool):
        self.solver = solver
        self.certify = certify
        self.cv = threading.Condition()
        self.jobs: list = []
        self.max_scores: list = []
        self.closed = False
        self.res: list = []
        self.st: list = []
        self.unc: list = []
        self.refuted: set = set()

    def add(self, job, max_score=None) -> int:
        with self.cv:
            self.jobs.append(job)
            self.max_scores.append(max_score)
            self.res.append(None)
            self.st.append(("envelope", 0))
            self.unc.append(None)
            k = len(self.jobs) - 1
            self.cv.notify()
        return k

    def close(self) -> None:
        with self.cv:
            self.closed = True
            self.cv.notify()

    def run(self) -> None:
        import time as _time

        from ..utils import perf

        t1 = self.solver.tiers[0]
        CH = t1.max_call
        taken = 0
        elig: list = []     # t1-eligible, awaiting dispatch
        # in-flight dispatch queue: a few chunks stay in flight, so chunk
        # N+1's upload and solve overlap chunk N's readback and decode;
        # per-job results do not depend on chunk grouping (tested)
        depth = max(1, int(os.environ.get("WFMASH_TPU_SEG_INFLIGHT", "3")))
        inflight: list = []
        st_str: dict = {}   # raw string statuses from _collect_chunk
        _t0 = [None]

        def _dispatch(chunk):
            if _t0[0] is None:
                _t0[0] = _time.monotonic()
            inflight.append(t1._dispatch_chunk(chunk, self.jobs,
                                               self.max_scores))
            perf.add("align.device_calls", 1)

        def _finish_one():
            disp = inflight.pop(0)
            t1._collect_chunk(disp, self.res, st_str, self.certify,
                              self.unc)
            for i in disp["idxs"]:
                s = st_str.get(i, "envelope")
                if s != "envelope":
                    self.st[i] = (s, t1.smax)
                if (s == "scorecap" and self.max_scores[i] is not None
                        and self.max_scores[i] <= t1.smax):
                    self.refuted.add(i)   # score > cap proven

        while True:
            with self.cv:
                while not self.closed and len(self.jobs) - taken < CH:
                    self.cv.wait(0.05)
                new_hi = len(self.jobs)
                closed = self.closed
            for k in range(taken, new_hi):
                q, t, ef = _job_parts(self.jobs[k])
                if not q or not t or t1.accepts(len(q), len(t), ef):
                    elig.append(k)
            taken = new_hi
            drained = closed and taken == len(self.jobs)
            while len(elig) >= CH or (drained and elig):
                chunk, elig = elig[:CH], elig[CH:]
                _dispatch(chunk)
                while len(inflight) > depth:
                    _finish_one()
            if drained and not elig:
                break
        while inflight:
            _finish_one()
        if _t0[0] is not None:
            perf.add("align.device_s", _time.monotonic() - _t0[0])
        # cascade the remainder through the deeper tiers (pooled)
        pending = [k for k in range(len(self.jobs))
                   if self.res[k] is None and k not in self.refuted]
        for tier in self.solver.tiers[1:]:
            if not pending:
                break
            idx = [i for i in pending
                   if tier.accepts(len(self.jobs[i][0]),
                                   len(self.jobs[i][1]),
                                   _job_parts(self.jobs[i])[2])]
            if idx:
                refuted = self.solver._run_tier(
                    tier, idx, self.jobs, self.certify, self.max_scores,
                    self.res, self.st, self.unc)
                pending = [i for i in pending
                           if self.res[i] is None and i not in refuted]
            else:
                pending = [i for i in pending if self.res[i] is None]
