"""Multi-device sharding for mapping and alignment.

The reference scales out via file-based job splitting (target subsets `-b`,
PAF chunking — SURVEY.md §2.7). The device equivalent expresses the
same decomposition on a `jax.sharding.Mesh`:

* axis "shard": the target minmer index is SHARDED by hash range — the
  spatial version of the reference's serial `-b` subset loop. Each device
  joins the (replicated) query sketches against its local posting slice;
  per-shard hit counts combine with a `psum`.
* axis "data": query fragments and WFA alignment problems are
  DATA-PARALLEL — each device advances its own batch of wavefronts in
  lockstep; no cross-chip communication is needed inside WFA.
* sequence-parallel: `diagonal_sharded_wfa_steps` splits ONE giant
  problem's wavefront-diagonal axis across the mesh with ring-history
  halo exchange (bit-identical to the single-device advance).

`multichip_step` is the canonical full step (fragment hash join + WFA
wavefront advance) used by __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_shard: int, n_data: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_shard * n_data
    dev = np.asarray(devices[: n_shard * n_data]).reshape(n_shard, n_data)
    return Mesh(dev, axis_names=("shard", "data"))


class ShardedDeviceL1:
    """PRODUCTION sharded L1: the real posting table (full 64-bit hashes
    as u32 pairs + endpoint CSR) sharded by HASH RANGE across the mesh's
    "shard" axis; fragment batches split across "data". Each shard joins
    locally, the padded endpoint slices all_gather, and every
    data slot runs the (deterministic) sweep on the merged event set —
    so candidates, and therefore the final PAF, are byte-identical to
    the single-device path (tested on the virtual 8-device CPU mesh).

    This is the spatial form of the reference's serial `-b` subset loop
    (reference: computeMap.hpp:295-327; index shards persist exactly like
    winSketch.hpp:616-979 batches)."""

    def __init__(self, index, group_arr, params, sketch_cutoffs,
                 mesh: Mesh, cap: int = 4096, maxc: int = 64):
        from ..map.l1_device import DeviceL1, _split_u64

        self.mesh = mesh
        self.n_shard = mesh.shape["shard"]
        self.n_data = mesh.shape["data"]
        self.cap = cap
        self.maxc = maxc
        self.params = params
        self.cutoffs = np.asarray(sketch_cutoffs, np.int32)
        self.cut_div = np.float32(max(1.0, params.sketch_size / 1000.0))
        self.group_arr = np.asarray(group_arr, np.int32)

        # split the unique-hash CSR into n_shard contiguous ranges,
        # balanced by endpoint count, padded to a common size
        uh = index.unique_hashes.astype(np.uint64)
        offs = index.endpoint_offsets.astype(np.int64)
        ep = index.endpoints
        U = len(uh)
        E = len(ep)
        bounds = [0]
        for s in range(1, self.n_shard):
            bounds.append(int(np.searchsorted(offs, E * s // self.n_shard)))
        bounds.append(U)
        us = max(max(bounds[i + 1] - bounds[i]
                     for i in range(self.n_shard)), 1)
        es = 1
        for i in range(self.n_shard):
            es = max(es, int(offs[bounds[i + 1]] - offs[bounds[i]]))
        self.uh_hi = np.zeros((self.n_shard, us), np.uint32)
        self.uh_lo = np.zeros((self.n_shard, us), np.uint32)
        self.offs = np.zeros((self.n_shard, us + 1), np.int32)
        self.ep_pos = np.zeros((self.n_shard, es), np.int32)
        self.ep_seq = np.zeros((self.n_shard, es), np.int32)
        self.ep_side = np.zeros((self.n_shard, es), np.int8)
        for i in range(self.n_shard):
            a, b = bounds[i], bounds[i + 1]
            n = b - a
            ea, eb = int(offs[a]), int(offs[b])
            hi, lo = _split_u64(uh[a:b])
            # pad hashes with the all-ones sentinel so no query matches
            self.uh_hi[i] = np.full(us, 0xFFFFFFFF, np.uint32)
            self.uh_lo[i] = np.full(us, 0xFFFFFFFF, np.uint32)
            self.uh_hi[i, :n] = hi
            self.uh_lo[i, :n] = lo
            self.offs[i, :n + 1] = (offs[a:b + 1] - ea).astype(np.int32)
            self.offs[i, n + 1:] = np.int32(eb - ea)
            self.ep_pos[i, :eb - ea] = ep["pos"][ea:eb].astype(np.int32)
            self.ep_seq[i, :eb - ea] = ep["seq_id"][ea:eb].astype(np.int32)
            self.ep_side[i, :eb - ea] = ep["side"][ea:eb]
        # real (unpadded) per-shard endpoint counts: the hash-range split
        # balances by endpoint count; dryrun_multichip reports the skew
        self.shard_ep_counts = [
            int(offs[bounds[i + 1]] - offs[bounds[i]])
            for i in range(self.n_shard)]
        self._jit = None

    def _build(self, S):
        from ..map.l1_device import (_join_endpoints, _sweep_candidates)

        p = self.params
        capL = self.cap // self.n_shard
        maxc = self.maxc
        mesh = self.mesh
        stage1 = bool(p.stage1_topANI_filter)
        cluster_len = np.int32(p.window_length)
        cut_div = self.cut_div

        def local(qh_hi, qh_lo, q_nh, meta, uh_hi, uh_lo, offs,
                  ep_pos, ep_seq, ep_side, seq_group, cutoffs):
            pos, seq, side, grp, over = _join_endpoints(
                qh_hi, qh_lo, q_nh, uh_hi[0], uh_lo[0], offs[0],
                ep_pos[0], ep_seq[0], ep_side[0], seq_group,
                meta[:, 0], meta[:, 1],
                meta[:, 5] != 0, meta[:, 6] != 0, cap=capL)
            # merge all shards' event slices (all_gather), then each
            # data slot sweeps the identical union deterministically
            def gather(x):
                g = jax.lax.all_gather(x, "shard", axis=0)
                return g.transpose(1, 0, 2).reshape(x.shape[0], -1)

            pos_a, seq_a = gather(pos), gather(seq)
            side_a, grp_a = gather(side), gather(grp)
            over = jax.lax.pmax(over.astype(jnp.int32), "shard")
            cand, ncand, run_over = _sweep_candidates(
                pos_a, seq_a, side_a, grp_a, meta[:, 2], meta[:, 3],
                cutoffs, cut_div, cluster_len, maxc=maxc, stage1=stage1)
            return cand, ncand, (over != 0) | run_over

        fn = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("data"), P("data"), P("data"), P("data"),
                      P("shard"), P("shard"), P("shard"), P("shard"),
                      P("shard"), P("shard"), P(None), P(None)),
            out_specs=(P("data"), P("data"), P("data")),
            check_vma=False)
        return jax.jit(fn)

    def candidates(self, frags):
        p = self.params
        B = len(frags)
        if B == 0:
            return []
        S = max(max(len(f["hashes"]) for f in frags), 1)
        # pow2 padding bucket: sketch sizes vary per batch (complexity
        # filter), and a fresh S means a fresh trace + compile; sentinel
        # hashes are masked by q_nh so extra padding is output-neutral
        S = 1 << (S - 1).bit_length()
        Bp = -(-B // self.n_data) * self.n_data
        qh = np.full((Bp, S), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
        q_nh = np.zeros(Bp, np.int32)
        meta = np.zeros((Bp, 8), np.int32)
        for i, f in enumerate(frags):
            h = np.asarray(f["hashes"], np.uint64)
            qh[i, :len(h)] = h
            q_nh[i] = len(h)
            meta[i, :5] = (f["q_group"], f["q_seqid"], f["min_hits"],
                           f["n"], f["q_len"])
        meta[:, 5] = int(p.skip_self or p.skip_prefix)
        meta[:, 6] = int(p.lower_triangular)
        from ..map.l1_device import _split_u64

        qh_hi, qh_lo = _split_u64(qh)
        if self._jit is None:
            self._jit = self._build(S)
        cand, ncand, overflow = self._jit(
            jnp.asarray(qh_hi), jnp.asarray(qh_lo), jnp.asarray(q_nh),
            jnp.asarray(meta), jnp.asarray(self.uh_hi),
            jnp.asarray(self.uh_lo), jnp.asarray(self.offs),
            jnp.asarray(self.ep_pos), jnp.asarray(self.ep_seq),
            jnp.asarray(self.ep_side), jnp.asarray(self.group_arr),
            jnp.asarray(self.cutoffs))
        cand = np.asarray(cand)
        ncand = np.asarray(ncand)
        overflow = np.asarray(overflow)
        out = []
        for i, f in enumerate(frags):
            if overflow[i] or f["q_len"] != p.window_length \
                    or not p.stage2_full_scan:
                out.append(None)
                continue
            out.append([tuple(int(x) for x in cand[i, j])
                        for j in range(int(ncand[i]))])
        return out


def sharded_hit_counts(query_hashes, index_hashes, mesh: Mesh):
    """Count query sketch hashes present in the (hash-sharded) index.

    query_hashes: (B, S) uint32-pair packed as int64-free 2x uint32? Here
    we use uint32 surrogate keys (the low word) for the join structure;
    exactness of the full 64-bit join lives in the host index (the device
    L1 join uses both words in the production path).

    index_hashes: (H,) sorted uint32, sharded by range across "shard".
    Returns (B,) counts summed over shards.
    """

    def local_count(qh, ih):
        # ih: this device's slice (sorted); count membership
        idx = jnp.searchsorted(ih, qh)
        idx = jnp.clip(idx, 0, ih.shape[0] - 1)
        found = ih[idx] == qh
        counts = found.sum(axis=1).astype(jnp.int32)
        return jax.lax.psum(counts, "shard")

    return jax.shard_map(
        local_count,
        mesh=mesh,
        in_specs=(P(None, None), P("shard")),
        out_specs=P(None),
    )(query_hashes, index_hashes)


def data_parallel_wfa_steps(off, query_w, target_w, qlen, tlen, mesh: Mesh,
                            n_steps: int, penalties):
    """Advance a data-sharded batch of wavefront rings n_steps scores."""
    from ..align.wfa_jax import _advance, make_blocks

    B, R, _, K = off.shape

    def local_steps(off, query_w, target_w, qlen, tlen):
        axis_q = qlen < 0  # all-False, derived from sharded input (vma-safe)
        mid = tlen // 2
        query_b = make_blocks(query_w)
        target_b = make_blocks(target_w)
        # derive from `off` so the carry is uniformly device-varying
        anc_v = jnp.full_like(off, -1)
        anc_h = jnp.full_like(off, -1)
        open_a = jnp.full_like(off[:, :, :4, :], -1)

        def body(s, carry):
            off, anc_v, anc_h, open_a = carry
            off, anc_v, anc_h, open_a, _, _, _ = _advance(
                off, anc_v, anc_h, open_a, s, query_b, target_b,
                qlen, tlen, axis_q, mid, K, R, penalties,
            )
            return (off, anc_v, anc_h, open_a)

        off, *_ = jax.lax.fori_loop(1, n_steps + 1, body,
                                    (off, anc_v, anc_h, open_a))
        return off

    return jax.shard_map(
        local_steps,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data"), P("data")),
        out_specs=P("data"),
    )(off, query_w, target_w, qlen, tlen)


def diagonal_sharded_wfa_steps(off, anc_v, anc_h, open_a, query_w,
                               target_w, qlen, tlen, axis_is_query, mid,
                               mesh: Mesh, n_steps: int, penalties):
    """Advance wavefront rings n_steps score levels with the DIAGONAL
    axis sharded across the mesh — the sequence-parallel path for ONE
    giant alignment that no single chip's K window can hold.

    This is the blockwise anti-diagonal decomposition (SURVEY §5
    long-context analogue; reference analogue: none — wfmash splits
    giant problems serially): each device owns a contiguous window of
    wavefront diagonals, and because every WFA recurrence reads only
    lanes k-1/k/k+1, one ring-history halo lane per side per score
    step suffices. Halos move via `ppermute`; sequences are
    replicated (uint8 words — gigabase-scale still fits HBM). The
    advanced rings are BIT-IDENTICAL to the single-device `_advance`
    loop (tests/test_multichip.py), so the crossing-anchor payload
    (biWFA midpoint recursion) works unchanged on top.

    off/anc_v/anc_h: (B, R, 5, K); open_a: (B, R, 4, K); K must be a
    multiple of the mesh's "data" size.
    """
    from ..align.wfa_jax import NEG_I, _advance, make_blocks

    axis = mesh.axis_names[-1]
    n = int(mesh.shape[axis])   # sharded over the LAST axis only
    B, R, _, K = off.shape
    if K % n:
        raise ValueError(f"K={K} not divisible by '{axis}' size {n}")
    NEG = NEG_I
    UNSET = -1

    def local_steps(off, anc_v, anc_h, open_a, query_w, target_w, qlen,
                    tlen, axis_is_query, mid):
        idx = jax.lax.axis_index(axis)
        Kl = off.shape[-1]
        query_b = make_blocks(query_w)
        target_b = make_blocks(target_w)
        # global diagonal of each padded lane (halo lanes included)
        kvec = (jnp.arange(Kl + 2, dtype=jnp.int32) - 1 + idx * Kl
                - K // 2)[None, :]
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i + 1, i) for i in range(n - 1)]

        def halo(a, fill):
            left = jax.lax.ppermute(a[..., -1:], axis, fwd)
            right = jax.lax.ppermute(a[..., :1], axis, bwd)
            left = jnp.where(idx == 0, fill, left)
            right = jnp.where(idx == n - 1, fill, right)
            return jnp.concatenate([left, a, right], axis=-1)

        def body(s, carry):
            off, anc_v, anc_h, open_a = carry
            off_p, av_p, ah_p, op_p, _, _, _ = _advance(
                halo(off, NEG), halo(anc_v, anc_v.dtype.type(UNSET)),
                halo(anc_h, anc_h.dtype.type(UNSET)),
                halo(open_a, open_a.dtype.type(UNSET)), s,
                query_b, target_b, qlen, tlen, axis_is_query, mid,
                Kl + 2, R, penalties, kvec=kvec)
            # halo lanes were computed without THEIR neighbors — drop
            # them; the owner shard recomputes them correctly and the
            # next step's halo refetches
            return (off_p[..., 1:-1], av_p[..., 1:-1],
                    ah_p[..., 1:-1], op_p[..., 1:-1])

        return jax.lax.fori_loop(1, n_steps + 1, body,
                                 (off, anc_v, anc_h, open_a))

    sh = P(None, None, None, axis)
    rep = P(*([None] * 2))
    return jax.shard_map(
        local_steps,
        mesh=mesh,
        in_specs=(sh, sh, sh, sh, rep, rep, P(None), P(None), P(None),
                  P(None)),
        out_specs=(sh, sh, sh, sh),
        check_vma=False,
    )(off, anc_v, anc_h, open_a, query_w, target_w, qlen, tlen,
      axis_is_query, mid)


def multichip_step(mesh: Mesh, penalties, n_steps: int = 8):
    """Build a jitted full step: L1 hash-join over the sharded index +
    data-parallel WFA advance. Returns (fn, example_args)."""
    n_shard = mesh.shape["shard"]
    n_data = mesh.shape["data"]
    from ..align.wfa_jax import ring_size, NEG_I, _pack_words

    R = ring_size(penalties)
    B = 2 * n_data
    K = 129
    L = 256
    S = 16
    H = 64 * n_shard

    rng = np.random.default_rng(0)
    q = rng.integers(65, 69, (B, L), dtype=np.uint8)
    t = q.copy()
    t[:, ::17] = 65  # a few mismatches
    query_w = _pack_words(q)
    target_w = _pack_words(t)
    qlen = np.full(B, L - 8, np.int32)
    tlen = np.full(B, L - 8, np.int32)
    off = np.full((B, R, 5, K), NEG_I, np.int32)
    off[:, 0, 0, K // 2] = 0

    qhash = rng.integers(0, 1 << 30, (B, S), dtype=np.uint32)
    ihash = rng.integers(0, 1 << 30, (H,), dtype=np.uint32)
    ihash[: S // 2] = qhash[0, : S // 2]  # guarantee some hits
    ihash = np.sort(ihash)

    def step(off, query_w, target_w, qlen, tlen, qhash, ihash):
        counts = sharded_hit_counts(qhash, ihash, mesh)
        out = data_parallel_wfa_steps(
            off, query_w, target_w, qlen, tlen, mesh, n_steps, penalties
        )
        return counts, out

    args = (
        jnp.asarray(off), jnp.asarray(query_w), jnp.asarray(target_w),
        jnp.asarray(qlen), jnp.asarray(tlen), jnp.asarray(qhash),
        jnp.asarray(ihash),
    )
    return jax.jit(step), args
