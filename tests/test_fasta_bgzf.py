"""BGZF virtual-offset reader (io/fasta.py) — faigz.h semantics:
block-level random access via .gzi (or a header scan), bounded memory,
fork-safe handles, byte-equal to whole-file decompression."""

import os
import struct
import zlib

import numpy as np
import pytest

from wfmash_tpu.io.fasta import (FastaReader, _BgzfData, _read_gzi,
                                 _scan_bgzf_blocks)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def seeded_bgzf(tmp_path_factory):
    """A seeded 1 Mb single-record BGZF FASTA (+ .fai, + .gzi), written by
    scripts/scale_demo.write_fasta_bgzf (~17 BGZF blocks)."""
    import sys

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from scale_demo import write_fasta_bgzf

    rng = np.random.default_rng(2024)
    path = str(tmp_path_factory.mktemp("bgzf") / "seeded.fa.gz")
    write_fasta_bgzf(path, "chrS", rng.integers(0, 4, 1_000_000)
                     .astype(np.uint8))
    return path


def bgzf_compress(data: bytes, block: int = 60000) -> bytes:
    """Minimal BGZF writer (spec-conforming blocks + EOF marker)."""
    out = bytearray()
    for i in range(0, len(data), block):
        chunk = data[i:i + block]
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        bsize = len(comp) + 25 + 1  # hdr 18 + crc 4 + isize 4 = 26... see below
        # header: magic, CM, FLG(FEXTRA), MTIME, XFL, OS, XLEN=6,
        # subfield BC len 2 value BSIZE-1
        total = 12 + 6 + len(comp) + 8
        hdr = struct.pack("<4BI2BH2B2H", 0x1f, 0x8b, 8, 4, 0, 0, 0, 6,
                          66, 67, 2, total - 1)
        out += hdr + comp + struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF,
                                        len(chunk))
    # EOF marker block (spec constant)
    out += bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
    return bytes(out)


def make_bgzf_fasta(tmp_path, seqs, block=60000):
    """Write a BGZF fasta + .fai; returns path."""
    buf = bytearray()
    fai = []
    for name, seq in seqs.items():
        buf += f">{name}\n".encode()
        off = len(buf)
        for i in range(0, len(seq), 60):
            buf += seq[i:i + 60] + b"\n"
        fai.append(f"{name}\t{len(seq)}\t{off}\t60\t61")
    path = tmp_path / "x.fa.gz"
    path.write_bytes(bgzf_compress(bytes(buf), block))
    (tmp_path / "x.fa.gz.fai").write_text("\n".join(fai) + "\n")
    return str(path)


def random_seq(rng, n):
    return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))


def test_lpa_bgzf_matches_whole_decompress(seeded_bgzf):
    r = FastaReader(seeded_bgzf)
    r._range(0, 1)          # force backend init
    assert r._kind == "bgzf"
    import gzip

    whole = gzip.decompress(open(seeded_bgzf, "rb").read())
    # reconstruct a reader that uses the gzip-whole path for comparison
    rng = np.random.default_rng(0)
    for name in r.names[:3]:
        L = r.seq_len(name)
        for _ in range(5):
            a = int(rng.integers(0, L))
            b = min(L - 1, a + int(rng.integers(1, 50_000)))
            got = r.fetch(name, a, b)
            assert len(got) == b - a + 1
            assert b"\n" not in got
    # full-sequence fetch equality vs a naive parse of the decompressed text
    name = r.names[0]
    seqs = {}
    cur = None
    for line in whole.split(b"\n"):
        if line.startswith(b">"):
            cur = line[1:].split()[0].decode()
            seqs[cur] = bytearray()
        elif cur:
            seqs[cur] += line
    assert r.fetch(name) == bytes(seqs[name])


def test_gzi_and_scan_agree(seeded_bgzf):
    gzi = _read_gzi(seeded_bgzf + ".gzi")
    scan = _scan_bgzf_blocks(seeded_bgzf)
    assert gzi is not None and scan is not None
    # the scan includes every block; .gzi may omit nothing but the EOF
    assert scan[:len(gzi)] == gzi


def test_synthetic_bgzf_bounded_cache(tmp_path):
    rng = np.random.default_rng(1)
    seqs = {"s1": random_seq(rng, 500_000), "s2": random_seq(rng, 200_000)}
    path = make_bgzf_fasta(tmp_path, seqs, block=4096)   # many tiny blocks
    r = FastaReader(path)
    # no .gzi -> header scan
    got = r.fetch("s2", 1000, 1999)
    assert got == seqs["s2"][1000:2000]
    assert r._kind == "bgzf"
    r._bgzf.CACHE_BLOCKS = 8
    for _ in range(50):
        a = int(rng.integers(0, 490_000))
        assert r.fetch("s1", a, a + 999) == seqs["s1"][a:a + 1000]
        assert len(r._bgzf._cache) <= 8
    # random access never materializes the file: cache is the only store
    assert r._data is None


def test_bgzf_fork_safe(tmp_path):
    import multiprocessing as mp

    rng = np.random.default_rng(2)
    seqs = {"s1": random_seq(rng, 100_000)}
    path = make_bgzf_fasta(tmp_path, seqs)
    r = FastaReader(path)
    assert r.fetch("s1", 10, 29) == seqs["s1"][10:30]

    def child(q):
        q.put(r.fetch("s1", 50_000, 50_099))

    ctx = mp.get_context("fork")
    q = ctx.Queue()
    p = ctx.Process(target=child, args=(q,))
    p.start()
    got = q.get(timeout=30)
    p.join()
    assert got == seqs["s1"][50_000:50_100]


def test_plain_gzip_spools_to_disk(tmp_path):
    """Non-BGZF gzip: stream-decompressed to an unlinked temp spool and
    mmap'd (bounded RAM) — byte-equal to the plain-file reader."""
    import gzip as _gzip
    import mmap as _mmap

    rng = np.random.default_rng(5)
    seqs = {"s1": random_seq(rng, 70001), "s2": random_seq(rng, 12345)}
    buf = bytearray()
    fai = []
    for name, seq in seqs.items():
        buf += f">{name}\n".encode()
        off = len(buf)
        for i in range(0, len(seq), 60):
            buf += seq[i:i + 60] + b"\n"
        fai.append(f"{name}\t{len(seq)}\t{off}\t60\t61")
    path = tmp_path / "plain.fa.gz"
    path.write_bytes(_gzip.compress(bytes(buf)))   # NOT BGZF
    (tmp_path / "plain.fa.gz.fai").write_text("\n".join(fai) + "\n")
    r = FastaReader(str(path))
    assert r.fetch("s1", 100, 199) == seqs["s1"][100:200]
    assert r.fetch("s2") == seqs["s2"]
    assert r._kind == "gzip"
    assert isinstance(r._data, _mmap.mmap)
