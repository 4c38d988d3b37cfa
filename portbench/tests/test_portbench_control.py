"""The correctness check must fail what is not correct.

The control (portbench/control.py: one bit of precision less, a lossy
writer or a lossy reader in the program's place) must read as not
correct, and so must a run whose timed path is broken underneath, once
for each fault a cell can have: a step that returns its state
unchanged (the answer of an earlier call; every window holds two calls
at least), half of the batch (half the blocks' splits) left out, and an
answer altered where it is produced. These cells run on one card, so
there is no exchange between chips to leave out. The runs skip the
harness's look for a card and run at a size the CPU holds.

    python -m pytest portbench/tests -q
"""

import io

import pytest
import torch

from portbench import control, harness
from portbench.tests._retired import load
from cblosc_tpu_torch.gpu import host_api, pipeline

CPU = torch.device("cpu")
CELLS = ["pyblosc-blosclz-c9.write", "zarr-lz4-c5.write",
         "pyblosc-blosclz-c9.read", "zarr-lz4-c5.read",
         "numcodecs-zlib-c5.read", "zarr-lz4-c5.getitem"]
# the plain LZ4 and DEFLATE walks are slow on the CPU: one block of 8
# splits, of 2 KiB (LZ4) and 1 KiB (zlib); a getitem mix reads 8 ranges
CHUNK_BYTES = {"zarr-lz4-c5.read": 16 << 10, "zarr-lz4-c5.getitem": 16 << 10,
               "numcodecs-zlib-c5.read": 8 << 10}


def spec_of(cell):
    spec = load(cell)
    spec.config["chunk_bytes"] = CHUNK_BYTES.get(cell, 32 << 10)
    spec.config["working_set_chunks"] = 3
    if "ranges" in spec.traffic:
        spec.traffic["ranges"] = 8
    return spec


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77])
@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct_and_the_program_correct(cell, seed):
    spec = spec_of(cell)
    sound = control.run_side(spec, seed, 0.2, CPU, False, io.StringIO())
    assert sound["correct"] and all(v == 0 for v in sound["check"].values())
    lossy = control.run_side(spec, seed, 0.2, CPU, True, io.StringIO())
    assert not lossy["correct"]
    assert lossy["check"]["wrong_bytes"] > 0


def test_drop_low_bit_drops_the_lowest_used_bit_only():
    import numpy as np

    words = np.array([0b1010_0000, 0b0110_0000, 0], dtype=np.uint64)
    got = control.drop_low_bit(words.tobytes() + b"\x07", 8)
    assert got[24:] == b"\x07"
    got = np.frombuffer(got[:24], dtype=np.uint64)
    assert got.tolist() == [0b1000_0000, 0b0100_0000, 0]


def _stale(fn):
    first = []

    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not first:
            first.append(out)
        return first[0]
    return broken


def _half_left_out(name):
    def wrap(fn):
        def broken(*args, **kwargs):
            a, b = fn(*args, **kwargs)
            if name == "compress_blocks":       # (slots, csizes)
                a, b = a.clone(), b.clone()
                half = b.shape[0] // 2
                b[half:] = 0
                a[half:] = 0
            elif name == "getitem":             # (blocks, err)
                # a getitem's answer is a few hundred bytes of a block:
                # every other byte is left out, so that each answer has
                # its half
                a = a.clone()
                a.reshape(-1)[1::2] = 0
            else:                               # (blocks, err)
                a = a.clone()
                flat = a.reshape(-1)
                flat[flat.numel() // 2:] = 0
            return a, b
        return broken
    return wrap


def _altered(name):
    def wrap(fn):
        if name == "getitem":       # the answer is produced by the byte API
            def broken_items(*args, **kwargs):
                out = bytearray(fn(*args, **kwargs))
                out[7] ^= 0xFF
                return bytes(out)
            return broken_items

        def broken(*args, **kwargs):
            a, b = fn(*args, **kwargs)
            a = a.clone()
            a.reshape(-1)[7] ^= 0xFF
            return a, b
        return broken
    return wrap


FAULTS = {"state unchanged": lambda name: _stale,
          "half of the batch left out": _half_left_out,
          "answer altered where produced": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_run_with_a_broken_timed_path_reads_not_correct(cell, fault,
                                                        monkeypatch):
    spec = spec_of(cell)
    op = spec.traffic["op"]
    name = {"compress": "compress_blocks"}.get(op, "decompress_blocks")
    broken = FAULTS[fault]("getitem" if op == "getitem" else name)
    if op == "getitem" and fault == "answer altered where produced":
        monkeypatch.setattr(host_api, "getitem",
                            broken(host_api.getitem))
    else:
        monkeypatch.setattr(pipeline, name, broken(getattr(pipeline, name)))
    line = harness.run_cell(spec, 3, 0.3, False, CPU, log=io.StringIO())
    assert line["correct"] is False, line["check"]
