"""End-to-end approximate-mapping tests on synthetic genomes."""

import io

import numpy as np
import pytest

from wfmash_tpu.params import MapParams
from wfmash_tpu.runner import run_mapping
from wfmash_tpu.io.paf import parse_paf_line

from util import mutate, random_dna, revcomp, write_fasta


def run_map(tmp_path, target_seqs, query_seqs, **overrides):
    tfa = tmp_path / "target.fa"
    qfa = tmp_path / "query.fa"
    write_fasta(tfa, target_seqs)
    write_fasta(qfa, query_seqs)
    params = MapParams(
        ref_sequences=[str(tfa)],
        query_sequences=[str(qfa)],
        percentage_identity=0.9,
        auto_pct_identity=False,
        **overrides,
    ).finalize()
    out = io.StringIO()
    run_mapping(params, out)
    return [parse_paf_line(l) for l in out.getvalue().splitlines()]


def test_exact_forward_mapping(tmp_path):
    rng = np.random.default_rng(0)
    target = random_dna(rng, 30_000)
    query = target[5_000:15_000]
    rows = run_map(tmp_path, {"t1": target}, {"q1": query})
    assert rows, "expected at least one mapping"
    r = rows[0]
    assert r["strand"] == "+"
    assert r["target_name"] == "t1"
    # merged mapping should span most of the query and sit at ~5000
    assert r["query_start"] < 1_500
    assert r["query_end"] > 8_500
    assert abs(r["target_start"] - (5_000 + r["query_start"])) < 1_200
    tags = r["tags"]
    assert "id" in tags and float(tags["id"][1]) > 0.95
    assert "ch" in tags


def test_reverse_strand_mapping(tmp_path):
    rng = np.random.default_rng(1)
    target = random_dna(rng, 30_000)
    # 6kb query is below the default 10k scaffold mass -> use scaffold_gap=0
    # (equivalent of -j 0, which disables the scaffold filter)
    query = revcomp(target[20_000:26_000])
    rows = run_map(tmp_path, {"t1": target}, {"q1": query}, scaffold_gap=0)
    assert rows
    assert all(r["strand"] == "-" for r in rows)
    covered = sum(r["query_end"] - r["query_start"] for r in rows)
    assert covered > 4_000


def test_scaffold_filter_drops_short_isolated_mappings(tmp_path):
    """With default -S 10k, a lone 6kb mapping yields no >=10k scaffold
    chain, hence no anchors, hence no output (mappingFilter.hpp:905-909)."""
    rng = np.random.default_rng(1)
    target = random_dna(rng, 30_000)
    query = revcomp(target[20_000:26_000])
    rows = run_map(tmp_path, {"t1": target}, {"q1": query})
    assert rows == []


def test_diverged_mapping(tmp_path):
    rng = np.random.default_rng(2)
    target = random_dna(rng, 25_000)
    query = mutate(rng, target[2_000:14_000], 0.05)  # ~95% identity, 12kb
    rows = run_map(tmp_path, {"t1": target}, {"q1": query})
    assert rows
    ident = max(float(r["tags"]["id"][1]) for r in rows)
    assert 0.85 < ident <= 1.0


def test_no_spurious_mapping(tmp_path):
    rng = np.random.default_rng(3)
    target = random_dna(rng, 20_000)
    query = random_dna(rng, 5_000)  # unrelated
    rows = run_map(tmp_path, {"t1": target}, {"q1": query})
    assert rows == []


def test_self_group_skip(tmp_path):
    """PanSN same-prefix sequences must not map to each other by default."""
    rng = np.random.default_rng(4)
    seq = random_dna(rng, 15_000)
    seqs = {"sampleA#1#chr1": seq, "sampleA#2#chr1": seq}
    rows = run_map(tmp_path, dict(seqs), dict(seqs))
    # both sequences share group prefix "sampleA#1"/"sampleA#2"?  PanSN group
    # = prefix before LAST '#', so groups are sampleA#1 vs sampleA#2 — they
    # DO map to each other.
    assert rows
    same = {"sampleB#1#chr1": seq, "sampleB#1#chr2": seq}
    rows2 = run_map(tmp_path, dict(same), dict(same))
    # same group (sampleB#1) -> skipped
    assert rows2 == []


def test_split_fragments_cover_long_query(tmp_path):
    rng = np.random.default_rng(5)
    target = random_dna(rng, 60_000)
    query = target[10_000:50_000]  # 40kb
    rows = run_map(tmp_path, {"t1": target}, {"q1": query})
    assert rows
    covered = np.zeros(40_000, dtype=bool)
    for r in rows:
        covered[r["query_start"]:r["query_end"]] = True
    assert covered.mean() > 0.95


def test_max_mapping_length_split(tmp_path):
    rng = np.random.default_rng(6)
    target = random_dna(rng, 120_000)
    query = target  # self copy, named differently
    rows = run_map(
        tmp_path, {"t1": target}, {"q1": query}, max_mapping_length=50_000
    )
    assert rows
    assert all(r["query_end"] - r["query_start"] <= 50_000 for r in rows)
    # chain tags should show multi-part chains
    chains = {r["tags"]["ch"][1].split(".")[0] for r in rows}
    assert len(chains) >= 1


def test_chain_tags_survive_group_filter(tmp_path):
    """A 120 kb near-identical query merges into one chain that the 50 kb
    max-mapping-length re-split turns into >= 2 rows: after the default
    plane-sweep group filter the rows must still carry their real
    ch:Z:id.pos.len tags (shared id, positions 1..len), not degraded
    identity chains (reference: mappingOutput.hpp:25-169;
    weak #4)."""
    rng = np.random.default_rng(7)
    target = random_dna(rng, 130_000)
    query = mutate(rng, target[2_000:122_000], 0.01)
    rows = run_map(tmp_path, {"t1": target}, {"q1": query})
    chains = {}
    for r in rows:
        cid, pos, ln = (int(x) for x in r["tags"]["ch"][1].split("."))
        chains.setdefault(cid, []).append((pos, ln))
    multi = [v for v in chains.values() if len(v) > 1]
    assert multi, "expected at least one multi-row chain"
    for entries in multi:
        # chainLen counts the RAW fragment mappings in the chain
        # (mappingFilter.hpp:519), chainPos the emitted re-split rows
        lens = {ln for _, ln in entries}
        assert len(lens) == 1 and lens.pop() >= len(entries)
        assert sorted(p for p, _ in entries) == list(range(1, len(entries) + 1))
