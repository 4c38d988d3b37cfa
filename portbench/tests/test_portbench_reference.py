"""The plain reference and the frozen writer, on the CPU.

The reference (portbench/reference.py) must read the chunks the program
writes for every configuration and the chunks the frozen C-blosc writer
writes, and must refuse or misread (never pass) a chunk with a byte
flipped. The writer's LZ4 and LZ4HC chunks are pinned by digest. The
codecs and filters of both are found by name, so a new one needs only
new files. These tests may import the program; the reference may not.

    python -m pytest portbench/tests -q
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]

from cblosc_tpu_torch import api  # noqa: E402
from cblosc_tpu_torch.core import backend, engine  # noqa: E402
from cblosc_tpu_torch.format import constants as C  # noqa: E402
from portbench import (  # noqa: E402
    check, cblosc_writer, codecs, filters, reference, traffic)

CONFIGS = {"pyblosc-blosclz-c9": (9, "blosclz"), "zarr-lz4-c5": (5, "lz4"),
           "numcodecs-zlib-c5": (5, "zlib")}


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
    assert h["codec"] == cname and h["filter"] == "SHUFFLE"
    assert reference.decompress(chunk) == data


def test_reference_reads_memcpyed_and_unshuffled_chunks():
    data = synth(4096, 5)
    raw = api.compress_ctx(0, C.SHUFFLE, 8, data, device="cpu")
    assert reference.header(raw)["memcpyed"]
    assert reference.decompress(raw) == data
    plain = api.compress_ctx(5, C.NOSHUFFLE, 8, data, compressor="lz4",
                             device="cpu")
    assert reference.header(plain)["filter"] == "NOSHUFFLE"
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
    # formats no module of codecs/ or filters/ reads yet: a zstd chunk, a
    # bitshuffled one; and a truncated chunk
    data = synth(64 << 10, 2)
    zstd = api.compress_ctx(5, C.SHUFFLE, 8, data, compressor="zstd",
                            device="cpu")
    bits = api.compress_ctx(5, C.BITSHUFFLE, 8, data, compressor="lz4",
                            device="cpu")
    for chunk in (zstd, bits, zstd[:10]):
        with pytest.raises(reference.ChunkError):
            reference.decompress(chunk)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference, portbench.check; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('cblosc_tpu_torch', 'cblosc_tpu', 'jax', 'torch')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("cname,code", [("lz4", C.LZ4), ("zlib", C.ZLIB)])
@pytest.mark.parametrize("nbytes,kind", [
    (4 << 20, "synth"), (256 << 10, "synth"), (100_000, "synth"),
    (1 << 20, "arange"), (64, "synth")])
def test_frozen_writer_equals_native_engine_and_reference_reads_it(
        nbytes, kind, cname, code):
    data = synth(nbytes, 7) if kind == "synth" else arange(nbytes)
    chunk = cblosc_writer.compress(5, "SHUFFLE", 8, data, cname)
    ctx = engine.build_context(5, C.SHUFFLE, 8, len(data), len(data) + 16,
                               code)
    assert chunk == backend.compress_chunk(ctx, data)
    assert reference.decompress(chunk) == data


# sha256 over the 32 input chunks of zarr-lz4-c5 (LZ4 at clevel 5, byte
# shuffle, typesize 8, 4 MiB of synth words each) as the writer wrote
# them before its codecs were split into files of their own
LZ4_CELL_DIGESTS = {
    1: "49fa5eec32e822c4e85449a3767aa39cca3d137c5e67d4913ab124b2a6478630",
    2147483648000:
        "6c07fdc2b39a24b7b4328fda45e80fc618cebea8ba7ae3a56107973f0f8c00bc",
}
# the same over the first 4 of those data chunks, other codecs and filters
OTHER_DIGESTS = {
    ("lz4hc", 5, "SHUFFLE", 1):
        "25cbb25dcc7085bb8f722b31934c222e1f66717123c2b30a4b9dfc1decdc611f",
    ("lz4hc", 9, "SHUFFLE", 1):
        "1d92e7ef86df1972642dd5349991d139056118ffca5b94a635677f87d12b7f51",
    ("lz4hc", 5, "SHUFFLE", 2147483648000):
        "65ec4f1d05d099d7a4bae853b118333b1daac80a627931bf95aa738132bdf09f",
    ("lz4hc", 9, "SHUFFLE", 2147483648000):
        "de11f6fc63a9451fe94e844569db095f851d0df75737a62006a254294e625436",
    ("lz4", 5, "NOSHUFFLE", 1):
        "337cd1e68738e21f2549d8107c8293cffc77bb562bedbeb839fe1547abef406c",
    ("lz4", 5, "BITSHUFFLE", 1):
        "0fa377fbe58ae655d1a60b4edcd632dd23661313569afa2fdf8de2d66f836613",
}


def _cell_config(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" /
                       f"{name}.json").read_text())


@pytest.mark.parametrize("seed", sorted(LZ4_CELL_DIGESTS))
def test_frozen_writer_writes_the_lz4_cell_chunks_it_always_wrote(seed):
    cfg = _cell_config("zarr-lz4-c5")
    c = cfg["codec"]
    data = traffic.make_data(cfg, seed)
    chunks = [cblosc_writer.compress(c["clevel"], c["shuffle"], c["typesize"],
                                     d, c["cname"]) for d in data]
    assert len(chunks) == 32
    assert hashlib.sha256(b"".join(chunks)).hexdigest() == \
        LZ4_CELL_DIGESTS[seed]
    for d, chunk in zip(data, chunks):
        assert reference.decompress(chunk) == d


@pytest.mark.parametrize("cname,clevel,shuffle,seed", sorted(OTHER_DIGESTS))
def test_frozen_writer_other_chunks_are_pinned(cname, clevel, shuffle,
                                                seed):
    cfg = {**_cell_config("zarr-lz4-c5"), "working_set_chunks": 4}
    chunks = [cblosc_writer.compress(clevel, shuffle, 8, d, cname)
              for d in traffic.make_data(cfg, seed)]
    assert hashlib.sha256(b"".join(chunks)).hexdigest() == \
        OTHER_DIGESTS[(cname, clevel, shuffle, seed)]


def test_reference_reads_the_programs_blosclz_c9_cell_chunk():
    cfg = {**_cell_config("pyblosc-blosclz-c9"), "working_set_chunks": 1}
    c = cfg["codec"]
    data = traffic.make_data(cfg, 2147483648000)[0]
    chunk = api.compress_ctx(c["clevel"], C.SHUFFLE, c["typesize"], data,
                             compressor=c["cname"], device="cpu")
    assert reference.header(chunk)["codec"] == "blosclz"
    assert reference.decompress(chunk) == data


def test_registries_list_exactly_what_their_files_hold():
    assert set(codecs.ALL) == {"blosclz", "lz4", "zlib"}
    assert set(codecs.BY_CNAME) == {"blosclz", "lz4", "lz4hc", "zlib"}
    assert set(filters.BY_NAME) == {"NOSHUFFLE", "SHUFFLE"}
    assert cblosc_writer.codecs() == {"lz4", "lz4hc", "zlib"}
    assert cblosc_writer.filters() == {"NOSHUFFLE", "SHUFFLE", "BITSHUFFLE"}
    with pytest.raises(ValueError, match="no codec"):
        cblosc_writer.compress(5, "SHUFFLE", 8, bytes(4096), "zstd")


# a codec added the new way, in a copy of the tree: "lz4twin", LZ4's
# wire format under compformat 6, with a reference module and a writer
# source of its own and no existing file edited
TWIN_PY = """from .lz4 import decode  # noqa: F401

COMPFORMAT = 6
VERSIONLZ = 1
CNAMES = ("lz4twin",)
"""
TWIN_CC = """#include "common.h"
#include "registry.h"

namespace {
int twin(int clevel, const uint8_t* src, int n, uint8_t* dst, int maxout) {
  return cbt::lz4_encode(src, n, dst, maxout, 10 - clevel);
}
[[maybe_unused]] const bool registered =
    pbw::add_codec({"lz4twin", 6, false, true, twin});
}  // namespace
"""
TWIN_RUN = """import sys
from portbench import cblosc_writer, codecs, reference, traffic
data = traffic.make_data({"data": {"generator": "synth",
                                   "significant_bits": 19},
                          "working_set_chunks": 1,
                          "chunk_bytes": 1 << 20}, 3)[0]
chunk = cblosc_writer.compress(5, "SHUFFLE", 8, data, "lz4twin")
h = reference.header(chunk)
assert h["codec"] == "lz4twin" and h["compformat"] == 6, h
assert reference.decompress(chunk) == data
assert "lz4twin" in cblosc_writer.codecs() and "lz4twin" in codecs.ALL
print("twin ok", len(chunk))
"""


def test_a_new_codec_needs_only_new_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {f: f.read_bytes() for f in (tmp_path / "portbench").rglob("*")
              if f.is_file()}
    (tmp_path / "portbench" / "codecs" / "lz4twin.py").write_text(TWIN_PY)
    (tmp_path / "portbench" / "writer" / "lz4twin.cc").write_text(TWIN_CC)
    assert all(f.read_bytes() == b for f, b in before.items())
    res = subprocess.run(
        [sys.executable, "-c", TWIN_RUN], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env={**os.environ, "PYTHONPATH":
                                     str(tmp_path)})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "twin ok" in res.stdout
