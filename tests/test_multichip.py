"""Multi-chip sharding (parallel/mesh.py) on the virtual 8-device mesh.

Validates the full multichip step — hash-sharded L1 join with a psum
over "shard" plus data-parallel WFA advance over "data" — compiles,
runs, and produces the same numbers as an unsharded single-device run.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from wfmash_tpu.align.wfa_np import Penalties
from wfmash_tpu.parallel.mesh import (
    make_mesh, multichip_step, sharded_hit_counts)

PATCH = Penalties(5, 8, 2, 24, 1)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_multichip_step_runs_2x4():
    mesh = make_mesh(2, 4)
    fn, args = multichip_step(mesh, PATCH, n_steps=8)
    counts, off = fn(*args)
    counts = np.asarray(counts)
    off = np.asarray(off)
    assert counts.shape[0] == args[5].shape[0]
    # seeded hits: problem 0 shares S//2 hashes with the index
    assert counts[0] >= args[5].shape[1] // 2
    assert off.shape == args[0].shape
    # wavefronts advanced: the first mismatch step (s = x = 5) wrote a
    # valid M row beyond the score-0 seed
    assert (off != np.asarray(args[0])).any()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_hit_counts_match_unsharded():
    rng = np.random.default_rng(1)
    B, S, H = 8, 32, 512
    qhash = rng.integers(0, 1 << 30, (B, S), dtype=np.uint32)
    ihash = np.sort(rng.integers(0, 1 << 30, (H,), dtype=np.uint32))
    for b in range(B):
        ihash[b * 16: b * 16 + b] = np.sort(qhash[b, :b])
    ihash = np.sort(ihash)

    mesh = make_mesh(4, 2)
    counts = np.asarray(sharded_hit_counts(
        jnp.asarray(qhash), jnp.asarray(ihash), mesh))

    # unsharded oracle
    idx = np.clip(np.searchsorted(ihash, qhash), 0, H - 1)
    expect = (ihash[idx] == qhash).sum(axis=1)
    np.testing.assert_array_equal(counts, expect)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_l1_production_candidates_match_host():
    """The REAL posting table sharded by hash range over a 4x2 mesh must
    produce candidate lists byte-identical to the host L1 path."""
    from test_l1_device import host_candidates

    from wfmash_tpu.index.build import build_index
    from wfmash_tpu.map.stats import compute_sketch_cutoffs
    from wfmash_tpu.parallel.mesh import ShardedDeviceL1
    from wfmash_tpu.params import MapParams
    from wfmash_tpu.sketch.minhash import sketch_fragment
    from util import random_dna

    rng = np.random.default_rng(23)
    mp = MapParams(percentage_identity=0.85, auto_pct_identity=False,
                   window_length=500, kmer_size=15)
    mp.ref_sequences = mp.query_sequences = ["x"]
    mp = mp.finalize()
    base = random_dna(rng, 25_000)
    seqs = [(0, base), (1, base[4_000:20_000]),
            (2, random_dna(rng, 8_000))]
    index = build_index(mp, seqs, log=lambda m: None)
    group_arr = np.array([0, 1, 2], np.int32)
    cutoffs = compute_sketch_cutoffs(mp.sketch_size, mp.kmer_size, 0.0,
                                     0.999)
    mesh = make_mesh(4, 2)
    dev = ShardedDeviceL1(index, group_arr, mp, cutoffs, mesh)
    frags, expected = [], []
    for trial in range(12):
        start = int(rng.integers(0, 24_000))
        fa = np.frombuffer(base[start:start + 500], np.uint8).copy()
        mut = rng.random(len(fa)) < 0.03
        fa[mut] = rng.integers(65, 69, int(mut.sum()))
        sk = sketch_fragment(fa.tobytes(), mp.kmer_size, mp.sketch_size)
        if sk.sketch_size == 0:
            continue
        frags.append(dict(hashes=sk.hashes, n=sk.sketch_size, q_len=500,
                          q_seqid=99, q_group=99, min_hits=2))
        expected.append(host_candidates(
            sk, 500, index, 99, 99, group_arr, mp, cutoffs, 2))
    got = dev.candidates(frags)
    assert len(got) == len(expected) >= 10
    for g, e in zip(got, expected):
        assert g == e
    assert any(expected)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_pipeline_paf_byte_identical(tmp_path, monkeypatch):
    """Full mapping pipeline: mesh-sharded device L1 vs host L1 must
    write byte-identical PAF."""
    import io

    from wfmash_tpu.params import MapParams
    from wfmash_tpu.runner import run_mapping
    from util import mutate, random_dna, write_fasta

    rng = np.random.default_rng(29)
    t1 = random_dna(rng, 22_000)
    t2 = random_dna(rng, 15_000)
    seqs_t = {"tA#1#c": t1, "tB#1#c": t2}
    seqs_q = {"q1#1#c": mutate(rng, t1[2_000:18_000], 0.03),
              "q2#1#c": mutate(rng, t2, 0.05)}
    tfa, qfa = tmp_path / "t.fa", tmp_path / "q.fa"
    write_fasta(tfa, seqs_t)
    write_fasta(qfa, seqs_q)

    def run(env_val):
        monkeypatch.setenv("WFMASH_TPU_DEVICE_L1", env_val)
        params = MapParams(
            ref_sequences=[str(tfa)], query_sequences=[str(qfa)],
            percentage_identity=0.9, auto_pct_identity=False,
            threads=1,
        ).finalize()
        out = io.StringIO()
        run_mapping(params, out)
        return out.getvalue()

    host = run("0")
    mesh = run("mesh")
    single = run("1")
    assert host, "empty mapping output"
    assert mesh == host
    assert single == host


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_device_pipeline_threads_byte_identical(tmp_path, monkeypatch):
    """The phase-structured device mapping driver (sketch fork pool ->
    batched device L1 in the parent -> L2/filter fork pool) must write
    the same PAF as the single-threaded host path."""
    import io

    from wfmash_tpu.params import MapParams
    from wfmash_tpu.runner import run_mapping
    from util import mutate, random_dna, write_fasta

    rng = np.random.default_rng(31)
    t1 = random_dna(rng, 30_000)
    seqs_t = {"tA#1#c": t1}
    seqs_q = {f"q{i}#1#c": mutate(rng, t1[i * 2_000:i * 2_000 + 12_000],
                                  0.04)
              for i in range(4)}
    tfa, qfa = tmp_path / "t.fa", tmp_path / "q.fa"
    write_fasta(tfa, seqs_t)
    write_fasta(qfa, seqs_q)

    def run(env_val, threads):
        monkeypatch.setenv("WFMASH_TPU_DEVICE_L1", env_val)
        params = MapParams(
            ref_sequences=[str(tfa)], query_sequences=[str(qfa)],
            percentage_identity=0.9, auto_pct_identity=False,
            threads=threads,
        ).finalize()
        out = io.StringIO()
        run_mapping(params, out)
        return out.getvalue()

    host = run("0", 1)
    assert host
    assert run("1", 4) == host      # device L1 + fork pools
    assert run("1", 1) == host      # device L1, serial phases


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_align_paf_byte_identical(tmp_path, monkeypatch):
    """Alignment with segment-kernel batches sharded over the 8-device
    mesh must write a PAF byte-identical to the single-device path
    """
    import io

    from wfmash_tpu.align.engine import run_alignment
    from wfmash_tpu.params import AlignParams, MapParams
    from wfmash_tpu.runner import run_mapping
    from util import mutate, random_dna, write_fasta

    rng = np.random.default_rng(37)
    t1 = random_dna(rng, 20_000)
    t2 = random_dna(rng, 14_000)
    q1 = mutate(rng, t1, 0.01)
    q2 = mutate(rng, t2, 0.04)
    tfa, qfa = tmp_path / "t.fa", tmp_path / "q.fa"
    write_fasta(tfa, {"tA#1#c": t1, "tB#1#c": t2})
    write_fasta(qfa, {"qA#1#c": q1, "qB#1#c": q2})
    mp = MapParams(ref_sequences=[str(tfa)], query_sequences=[str(qfa)],
                   percentage_identity=0.9, auto_pct_identity=False,
                   threads=1).finalize()
    buf = io.StringIO()
    run_mapping(mp, buf)
    mpaf = tmp_path / "m.paf"
    mpaf.write_text(buf.getvalue())

    def run(mesh_mode):
        monkeypatch.setenv("WFMASH_TPU_ALIGN_MESH", mesh_mode)
        monkeypatch.setenv("WFMASH_TPU_WFA_ENGINE", "auto")
        ap = AlignParams(ref_sequences=[str(tfa)],
                         query_sequences=[str(qfa)],
                         mashmap_paf_file=str(mpaf))
        out = io.StringIO()
        run_alignment(ap, out)
        return out.getvalue()

    single = run("0")
    assert single
    assert run("force") == single


def test_diagonal_sharded_wfa_bit_identical():
    """The diagonal-sharded wavefront advance (one giant problem's K
    axis split over the mesh, ring-history halos over ppermute) is
    bit-identical to the single-device _advance loop — offsets AND the
    crossing-anchor payload, so biWFA midpoint recursion works on top."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from wfmash_tpu.align.wfa_jax import (
        NEG_I, _advance, _pack_words, make_blocks, ring_size,
    )
    from wfmash_tpu.align.wfa_np import Penalties
    from wfmash_tpu.parallel.mesh import diagonal_sharded_wfa_steps

    p = Penalties(5, 8, 2, 24, 1)
    R = ring_size(p)
    B, K, L = 2, 256, 480
    rng = np.random.default_rng(0)
    q = rng.integers(65, 69, (B, L), dtype=np.uint8)
    t = q.copy()
    t[:, ::11] = 65
    t[:, ::29] = 67
    query_w = jnp.asarray(_pack_words(q))
    target_w = jnp.asarray(_pack_words(t))
    qlen = jnp.full((B,), L - 8, jnp.int32)
    tlen = jnp.full((B,), L - 12, jnp.int32)
    off = np.full((B, R, 5, K), NEG_I, np.int32)
    off[:, 0, 0, K // 2] = 0
    off = jnp.asarray(off)
    anc_v = jnp.full((B, R, 5, K), -1, jnp.int32)
    anc_h = anc_v
    open_a = jnp.full((B, R, 4, K), -1, jnp.int32)
    axis_q = jnp.zeros((B,), bool)
    mid = tlen // 2
    n_steps = 48

    qb, tb = make_blocks(query_w), make_blocks(target_w)

    def body(s, carry):
        o, av, ah, op = carry
        o, av, ah, op, _, _, _ = _advance(
            o, av, ah, op, s, qb, tb, qlen, tlen, axis_q, mid, K, R, p)
        return (o, av, ah, op)

    ref = jax.lax.fori_loop(1, n_steps + 1, body,
                            (off, anc_v, anc_h, open_a))
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    got = diagonal_sharded_wfa_steps(
        off, anc_v, anc_h, open_a, query_w, target_w, qlen, tlen,
        axis_q, mid, mesh, n_steps, p)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), np.asarray(b))
