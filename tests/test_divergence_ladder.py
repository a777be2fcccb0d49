"""Divergence-ladder cap validation.

The capped-default align path (probe 100 / refine 800 / junk 0.55) is
a documented approximation; this pins how far it may drift from the
exact optimum as divergence grows. Full sweep + measured table:
scripts/divergence_ladder.py (ARCHITECTURE.md fidelity ledger —
measured deltas are ~100x under these bounds)."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

from divergence_ladder import coverage, parse_rows, run_pair, write_pair


def _ladder_point(tmp_path, div: float, pct: float, bp: int = 60000):
    pt = str(tmp_path / "t.fa")
    pq = str(tmp_path / "q.fa")
    write_pair(pt, pq, bp, div, seed=11)
    d_text, e_text = run_pair(pt, pq, pct)
    d_rows, e_rows = parse_rows(d_text), parse_rows(e_text)
    common = set(d_rows) & set(e_rows)
    assert common, "no comparable rows"
    deltas = [e_rows[k][0] - d_rows[k][0] for k in common]
    cov_d = coverage(d_rows, bp)
    cov_e = coverage(e_rows, bp)
    return deltas, cov_d, cov_e


def test_capped_default_tracks_exact_at_5pct(tmp_path):
    deltas, cov_d, cov_e = _ladder_point(tmp_path, 0.05, 0.90)
    assert abs(float(np.mean(deltas))) <= 0.002
    assert max(abs(d) for d in deltas) <= 0.01
    assert abs(cov_d - cov_e) <= 0.005


def test_capped_default_tracks_exact_at_15pct(tmp_path):
    deltas, cov_d, cov_e = _ladder_point(tmp_path, 0.15, 0.80)
    assert abs(float(np.mean(deltas))) <= 0.002
    assert max(abs(d) for d in deltas) <= 0.01
    assert abs(cov_d - cov_e) <= 0.005


def test_capped_default_tracks_exact_at_ani_floor(tmp_path):
    """~25% divergence at the reference's -p 70 identity floor
    (map_parameters.hpp:126)."""
    deltas, cov_d, cov_e = _ladder_point(tmp_path, 0.25, 0.70)
    assert abs(float(np.mean(deltas))) <= 0.003
    assert max(abs(d) for d in deltas) <= 0.02
    assert abs(cov_d - cov_e) <= 0.01
