"""Routing by platform, loud device failures, and the compile cache.

On a GPU the mapping runs device L1/L2 and the aligner the segmented
engine on the card; elsewhere the native host engines. The GPU branch is
exercised here by patching the platform test, with the plain-JAX solver
standing in for the CUDA kernel."""

import os

import numpy as np
import pytest

from wfmash_tpu.align import engine as E
from wfmash_tpu.align import wfa_seg
from wfmash_tpu.align.biwfa import HostWfaEngine
from wfmash_tpu.align.segmented import SegmentedEngine
from wfmash_tpu.utils import jaxcache, perf

from util import mutate, random_dna, write_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(**kw):
    from wfmash_tpu.params import AlignParams

    return AlignParams(**kw)


def test_cpu_routes_to_native_host_engine(monkeypatch):
    from wfmash_tpu.native import get_wfa_lib

    monkeypatch.delenv("WFMASH_TPU_SEGMENTED", raising=False)
    monkeypatch.delenv("WFMASH_TPU_WFA_ENGINE", raising=False)
    eng = E.make_engine(_params())
    if get_wfa_lib() is not None:
        assert isinstance(eng, E.BudgetedHostEngine)


def test_gpu_routes_to_segmented_device_engine(monkeypatch):
    monkeypatch.delenv("WFMASH_TPU_SEGMENTED", raising=False)
    monkeypatch.delenv("WFMASH_TPU_WFA_ENGINE", raising=False)
    monkeypatch.setattr(E, "_on_gpu", lambda: True)
    eng = E.make_engine(_params())
    assert isinstance(eng, SegmentedEngine)
    assert isinstance(eng.solver, wfa_seg.TieredSegmentSolver)
    # small jobs stay on the device tiers
    assert not eng._host_smalls_ok()
    assert eng.exact.seg_solver is eng.solver


def test_host_engine_override_on_gpu(monkeypatch):
    monkeypatch.setenv("WFMASH_TPU_WFA_ENGINE", "host")
    monkeypatch.setattr(E, "_on_gpu", lambda: True)
    assert isinstance(E.make_engine(_params()), HostWfaEngine)


def _mapping_inputs(tmp_path, n=60_000, seed=3):
    rng = np.random.default_rng(seed)
    t = random_dna(rng, n)
    q = mutate(rng, t, 0.02)
    pt, pq = str(tmp_path / "t.fa"), str(tmp_path / "q.fa")
    write_fasta(pt, {"t1": t})
    write_fasta(pq, {"q1": q, "q2": q[::-1]})
    return pt, pq


def _run_map(pt, pq, threads=1):
    import io

    from wfmash_tpu import cli

    mp, _, _, _ = cli.parse_args([pt, pq, "-m", "-t", str(threads)])
    out = io.StringIO()
    from wfmash_tpu.runner import run_mapping

    run_mapping(mp, out)
    return out.getvalue()


@pytest.mark.parametrize("on_gpu", [False, True])
def test_mapping_routes_by_platform(tmp_path, monkeypatch, on_gpu):
    """Device L1/L2 only on a GPU; the PAF is the same either way."""
    from wfmash_tpu import runner

    monkeypatch.delenv("WFMASH_TPU_DEVICE_L1", raising=False)
    pt, pq = _mapping_inputs(tmp_path)
    host = _run_map(pt, pq)
    monkeypatch.setattr(runner, "_on_gpu", lambda: on_gpu)
    perf.reset()
    got = _run_map(pt, pq, threads=2)
    assert (perf.get("map.device_calls") > 0) == on_gpu
    assert (perf.get("map.l2_device_calls") > 0) == on_gpu
    assert got == host and got


def test_gpu_mapping_workers_are_threads(monkeypatch):
    """No fork under a live device runtime: the per-query pools are
    threads on a GPU, processes elsewhere."""
    from multiprocessing.pool import ThreadPool

    from wfmash_tpu import runner

    monkeypatch.setattr(runner, "_on_gpu", lambda: True)
    with runner._worker_pool(2) as pool:
        assert isinstance(pool, ThreadPool)
    monkeypatch.setattr(runner, "_on_gpu", lambda: False)
    with runner._worker_pool(2) as pool:
        assert not isinstance(pool, ThreadPool)


def test_mapping_device_error_is_raised(tmp_path, monkeypatch):
    from wfmash_tpu import runner
    from wfmash_tpu.map import l1_device

    def boom(self, frags):
        raise RuntimeError("device L1 failed")

    monkeypatch.setattr(runner, "_on_gpu", lambda: True)
    monkeypatch.setattr(l1_device.DeviceL1, "candidates", boom)
    pt, pq = _mapping_inputs(tmp_path)
    with pytest.raises(RuntimeError, match="device L1 failed"):
        _run_map(pt, pq)


def _align_fixture(tmp_path):
    """A 6 kb pair and its mapping PAF."""
    rng = np.random.default_rng(9)
    t = random_dna(rng, 6000)
    q = mutate(rng, t, 0.03)
    pt, pq = str(tmp_path / "t.fa"), str(tmp_path / "q.fa")
    write_fasta(pt, {"t1": t})
    write_fasta(pq, {"q1": q})
    paf = str(tmp_path / "map.paf")
    with open(paf, "w") as fh:
        fh.write(f"q1\t6000\t0\t6000\t+\tt1\t6000\t0\t6000\t5800\t6000\t"
                 f"60\tid:f:0.97\n")
    from wfmash_tpu import cli

    _, ap, _, _ = cli.parse_args([pt, pq, "-i", paf])
    return ap


def _failing_segmented(monkeypatch):
    def fail(self, *a, **k):
        raise RuntimeError("segment solver failed")

    monkeypatch.setattr(wfa_seg.SegmentSolver, "_dispatch_chunk", fail)
    from wfmash_tpu.align.wfa_jax import JaxWfaEngine

    pen = E.align_penalties(_params())
    return SegmentedEngine(pen, JaxWfaEngine(pen), min_block=100)


def test_device_align_error_stops_the_run(tmp_path, monkeypatch):
    """On the GPU path a failing solver raises out of run_alignment —
    no per-record retry, no dropped rows."""
    import io

    ap = _align_fixture(tmp_path)
    eng = _failing_segmented(monkeypatch)
    monkeypatch.setattr(E, "_on_gpu", lambda: True)
    out = io.StringIO()
    with pytest.raises(RuntimeError, match="segment solver failed"):
        E.run_alignment(ap, out, engine=eng)
    assert out.getvalue() == ""


def test_host_engine_rows_survive(tmp_path):
    """The host path aligns the same fixture to one replayable row."""
    import io

    ap = _align_fixture(tmp_path)
    out = io.StringIO()
    E.run_alignment(ap, out, engine=E.BudgetedHostEngine(
        E.align_penalties(ap), ap))
    rows = out.getvalue().splitlines()
    assert len(rows) == 1 and "cg:Z:" in rows[0]


def _cache_calls(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jaxcache, "_done", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return calls


def test_jaxcache_honours_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _cache_calls(monkeypatch)
    jaxcache.enable()
    assert calls == []                     # JAX reads the variable itself
    assert jaxcache.cache_dir() == str(tmp_path)


def test_jaxcache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _cache_calls(monkeypatch)
    jaxcache.enable()
    jaxcache.enable()                      # idempotent
    want = os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", want)]
    assert jaxcache.cache_dir() == want
