"""Device (JAX) WFA engine vs the host reference and DP oracle."""

import numpy as np
import pytest

from wfmash_tpu.align import cigar as C
from wfmash_tpu.align.wfa_jax import JaxWfaEngine
from wfmash_tpu.align.wfa_np import Penalties, dp_align, score_cigar

from test_wfa import make_pair
from util import random_dna

PATCH = Penalties(5, 8, 2, 24, 1)


@pytest.fixture(scope="module")
def engine():
    # small host cutoff + span so the device sweep path is exercised
    return JaxWfaEngine(PATCH, batch_size=8, host_len=120, max_span=257)


@pytest.mark.parametrize("seed", range(3))
def test_jax_engine_matches_oracle(engine, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(250, 500))
    query, target = make_pair(rng, n, sub=0.04, indel=0.015, max_indel=10)
    ops = engine.align(query, target)
    assert C.validate(ops, query, target, 0, 0)
    _, _, _, _, _, _, ref_len, q_len = C.stats(ops)
    assert q_len == len(query) and ref_len == len(target)
    assert score_cigar(ops, PATCH) == dp_align(query, target, PATCH)


def test_jax_engine_batch(engine):
    rng = np.random.default_rng(42)
    jobs = []
    for _ in range(4):
        n = int(rng.integers(250, 450))
        q, t = make_pair(rng, n, sub=0.05, indel=0.015, max_indel=8)
        jobs.append((q, t, None))
    results = engine.align_batch(jobs)
    for (q, t, _), ops in zip(jobs, results):
        assert C.validate(ops, q, t, 0, 0)
        assert score_cigar(ops, PATCH) == dp_align(q, t, PATCH)


def test_jax_engine_identical(engine):
    rng = np.random.default_rng(1)
    s = random_dna(rng, 800)
    ops = engine.align(s, s)
    assert ops == [(800, "=")]


def test_jax_engine_big_insertion(engine):
    rng = np.random.default_rng(2)
    a = random_dna(rng, 200)
    b = random_dna(rng, 200)
    ins = random_dna(rng, 60)
    query = a + ins + b
    target = a + b
    ops = engine.align(query, target)
    assert C.validate(ops, query, target, 0, 0)
    assert score_cigar(ops, PATCH) == dp_align(query, target, PATCH)


def test_jax_engine_leading_gap(engine):
    """Gap at the origin exercises the degenerate-anchor axis retry."""
    rng = np.random.default_rng(3)
    core = random_dna(rng, 400)
    query = random_dna(rng, 80) + core
    target = core
    ops = engine.align(query, target)
    assert C.validate(ops, query, target, 0, 0)
    assert score_cigar(ops, PATCH) == dp_align(query, target, PATCH)


def test_big_skew_routes_to_host():
    """A block whose |m-n| exceeds the diagonal span budget (multi-kb
    copy-number gap) must fall back to the host solver instead of
    raising 'exceeds the diagonal span budget' (round-2 fix)."""
    from util import random_dna
    from wfmash_tpu.align import cigar as C

    rng = np.random.default_rng(31)
    t = random_dna(rng, 9000)
    ins = random_dna(rng, 3000)
    q = t[:4000] + ins + t[4000:]
    eng = JaxWfaEngine(PATCH)
    ops = eng.align_batch([(q, t, None)])[0]
    assert C.validate(ops, q, t, 0, 0)
    assert max((n for n, op in ops if op == "I"), default=0) >= 2900
