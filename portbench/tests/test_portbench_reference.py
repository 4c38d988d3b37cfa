"""The plain reference and the frozen writer, on the CPU.

The reference (portbench/reference.py) must read the chunks the program
writes for both configurations and the chunks the frozen C-blosc writer
writes, and must refuse or misread (never pass) a chunk with a byte
flipped. These tests may import the program; the reference may not.

    python -m pytest portbench/tests -q
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]

from cblosc_tpu_torch import api  # noqa: E402
from cblosc_tpu_torch.core import backend, engine  # noqa: E402
from cblosc_tpu_torch.format import constants as C  # noqa: E402
from portbench import check, cblosc_writer, reference, traffic  # noqa: E402

CONFIGS = {"pyblosc-blosclz-c9": (9, "blosclz"), "zarr-lz4-c5": (5, "lz4")}


def synth(nbytes: int, seed: int) -> bytes:
    cfg = {"data": {"generator": "synth", "significant_bits": 19},
           "working_set_chunks": 1, "chunk_bytes": nbytes}
    return traffic.make_data(cfg, seed)[0]


def arange(nbytes: int) -> bytes:
    return np.arange(nbytes // 4, dtype=np.int32).tobytes()


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("nbytes,kind", [
    (64 << 10, "synth"), (256 << 10, "synth"), (100_000, "synth"),
    (64 << 10, "arange"), (1000, "synth")])
def test_reference_reads_program_chunks(config, nbytes, kind):
    clevel, cname = CONFIGS[config]
    data = synth(nbytes, 3) if kind == "synth" else arange(nbytes)
    chunk = api.compress_ctx(clevel, C.SHUFFLE, 8, data, compressor=cname,
                             device="cpu")
    h = reference.header(chunk)
    assert h["codec"] == cname and h["shuffle"]
    assert reference.decompress(chunk) == data


def test_reference_reads_memcpyed_and_unshuffled_chunks():
    data = synth(4096, 5)
    raw = api.compress_ctx(0, C.SHUFFLE, 8, data, device="cpu")
    assert reference.header(raw)["memcpyed"]
    assert reference.decompress(raw) == data
    plain = api.compress_ctx(5, C.NOSHUFFLE, 8, data, compressor="lz4",
                             device="cpu")
    assert not reference.header(plain)["shuffle"]
    assert reference.decompress(plain) == data


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_reference_fails_on_every_flipped_byte(config):
    clevel, cname = CONFIGS[config]
    data = synth(64 << 10, 11)
    chunk = api.compress_ctx(clevel, C.SHUFFLE, 8, data, compressor=cname,
                             device="cpu")
    rng = np.random.default_rng(4)
    picks = sorted(set(range(16)) | set(rng.choice(len(chunk), 300).tolist()))
    for pos in picks:
        bad = bytearray(chunk)
        bad[pos] ^= 0xFF
        assert check.decoded_wrong(bytes(bad), data) > 0, pos


def test_reference_rejects_what_it_does_not_read():
    data = synth(64 << 10, 2)
    chunk = api.compress_ctx(5, C.SHUFFLE, 8, data, compressor="zlib",
                             device="cpu")
    with pytest.raises(reference.ChunkError):
        reference.decompress(chunk)
    with pytest.raises(reference.ChunkError):
        reference.decompress(chunk[:10])


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference, portbench.check; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('cblosc_tpu_torch', 'cblosc_tpu', 'jax', 'torch')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("nbytes,kind", [
    (4 << 20, "synth"), (256 << 10, "synth"), (100_000, "synth"),
    (1 << 20, "arange"), (64, "synth")])
def test_frozen_writer_equals_native_engine_and_reference_reads_it(
        nbytes, kind):
    data = synth(nbytes, 7) if kind == "synth" else arange(nbytes)
    chunk = cblosc_writer.compress(5, "SHUFFLE", 8, data, "lz4")
    ctx = engine.build_context(5, C.SHUFFLE, 8, len(data), len(data) + 16,
                               C.LZ4)
    assert chunk == backend.compress_chunk(ctx, data)
    assert reference.decompress(chunk) == data
