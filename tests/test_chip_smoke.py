"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phases work at a tiny size (device paths forced onto the CPU backend)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from wfmash_tpu.align.wfa_np import Penalties  # noqa: E402

PATCH = Penalties(5, 8, 2, 24, 1)


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no gpu" in r.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_device():
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.phase_device()
    dev = chip_smoke.phase_device(want_platform="cpu")
    assert dev["platform"] == "cpu" and dev["count"] >= 1


def test_phase_segment_kernels_tiny():
    times = chip_smoke.phase_segment_kernels(
        PATCH, n_per_tier=(12, 6, 4, 2, 4), kernels=("lax",), procs=1)
    assert sorted(times) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("tier", range(5))
def test_tier_jobs_fit_their_tier(tier):
    from wfmash_tpu.align.wfa_seg import TieredSegmentSolver

    solver = TieredSegmentSolver(PATCH, kernel="lax").tiers[tier]
    jobs = chip_smoke.make_tier_jobs(tier, 40, seed=3)
    fit = sum(solver.accepts(len(q), len(t), ef) for q, t, ef in jobs)
    assert fit >= 30


def test_phase_long_sweep_tiny():
    chip_smoke.phase_long_sweep(PATCH, bp=3000)


def test_phase_mapping_kernels_tiny():
    fx = chip_smoke.mapping_fixture(bp=300_000, n_frags=24)
    chip_smoke.phase_mapping_kernels(fx)


def _tiny_pair(tmp_path, bp=200_000, seed=5):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from scale_demo import write_fasta_bgzf

    rng = np.random.default_rng(seed)
    anc = rng.integers(0, 4, bp).astype(np.uint8)
    der = chip_smoke._mutate(rng, anc, 0.02, 0.001)
    pt, pq = str(tmp_path / "anc.fa.gz"), str(tmp_path / "der.fa.gz")
    write_fasta_bgzf(pt, "anc", anc)
    write_fasta_bgzf(pq, "der", der)
    return pt, pq, chip_smoke._dna(anc), chip_smoke._dna(der)


def _force_device_paths(monkeypatch):
    """The GPU routing on the CPU backend: device L1/L2 and the
    segmented engine (other test modules pin the host engine)."""
    monkeypatch.delenv("WFMASH_TPU_WFA_ENGINE", raising=False)
    monkeypatch.setenv("WFMASH_TPU_DEVICE_L1", "1")
    monkeypatch.setenv("WFMASH_TPU_SEGMENTED", "1")


def test_phase_four_tiny(tmp_path, monkeypatch):
    """The multi-device phase on the 8 virtual CPU devices: sharded L1
    and sharded alignment equal their one-device runs."""
    _force_device_paths(monkeypatch)
    monkeypatch.setenv("WFMASH_TPU_ALIGN_MESH", "force")
    fx = chip_smoke.mapping_fixture(bp=300_000, n_frags=24)
    chip_smoke.phase_four(fx, _tiny_pair(tmp_path, bp=100_000), 2,
                          str(tmp_path / "out"))


def test_phase_end_to_end_tiny(tmp_path, monkeypatch):
    """Map + align a 200 kb pair with the device paths forced onto the
    CPU backend: mapping PAF equals host mapping, CIGARs replay, the
    warm pass compiles nothing."""
    _force_device_paths(monkeypatch)
    chip_smoke.phase_end_to_end(_tiny_pair(tmp_path), 2,
                                str(tmp_path / "out"))
