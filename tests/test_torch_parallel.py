"""PyTorch port's sharded engine (cblosc_tpu_torch.parallel, on
torch.distributed) vs cblosc_tpu.parallel on the 8-virtual-device CPU
mesh (conftest).

One group of 4 gloo processes (CPU, a FileStore under tmp_path, one
torch thread each) runs every multi-rank case, and each rank writes what
it returned to a file that the test holds against JAX on make_mesh(4)
and make_mesh_2d(4, 2) here:
  * the byte API, blosclz and lz4, on a buffer whose full blocks do not
    divide by 4 (a host-engine tail) and with a leftover block, a tiny
    buffer and an incompressible one: chunks byte-equal to JAX's,
    decompress_chunk returns the input;
  * compress_blocks_sharded / decompress_blocks_sharded: each rank's
    slots, csizes and offsets equal JAX's slice, total equal;
  * training_step and training_step_2d (2 x 2): round trips, JAX's total;
  * a block count that the mesh does not divide: JAX's ValueError.
Also a one-rank group in this process, and make_mesh without a group.
The group's init and every child have time limits, so a hung collective
fails the test instead of running out the suite's clock."""

import datetime
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import cblosc_tpu as jb
from cblosc_tpu import parallel as jpar
from cblosc_tpu.format import constants as C
from cblosc_tpu.utils.timing import synth
from cblosc_tpu_torch import parallel as tpar

WORLD = 4
BS = 65536
# six full 64 KB blocks (6 % 4 = 2 go to the host engine) and a leftover
BYTE_CASES = {
    "blosclz-tail": (1, C.SHUFFLE, 8, "synth", 6 * BS + 1234, C.BLOSCLZ),
    "lz4-tail": (1, C.SHUFFLE, 8, "synth", 6 * BS + 1234, C.LZ4),
    "tiny": (1, C.SHUFFLE, 4, "arange", 100, C.BLOSCLZ),
    "incompressible": (1, C.SHUFFLE, 8, "random", 4 * BS, C.BLOSCLZ),
}
# blocks of compress_blocks_sharded (16 x 8 KB, typesize 4, 4 splits) and
# of the training steps (8 x 4 KB ramps, typesize 4, 4 splits)
NB_SH, BS_SH, NB_TR, BS_TR, T = 16, 8192, 8, 4096, 4


# the inputs, made from seeds with numpy; run here with the JAX
# package's synth and in the ranks with the port's copy of it
_INPUTS = """
def _byte_data(kind, n):
    if kind == "synth":
        return synth(n, 8, 19).tobytes()
    if kind == "arange":
        return np.arange(n // 4, dtype=np.int32).tobytes()[:n]
    return np.random.default_rng(11).integers(0, 256, n,
                                              dtype=np.uint8).tobytes()


def _sharded_blocks():
    rng = np.random.default_rng(12)
    return (rng.integers(0, 8, NB_SH * BS_SH, dtype=np.uint8) * 16).reshape(
        NB_SH, BS_SH)


def _train_blocks():
    a = np.arange(NB_TR * BS_TR // 4, dtype=np.int32)
    return a.view(np.uint8).reshape(NB_TR, BS_TR)
"""
exec(_INPUTS)

_WORKER = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    from cblosc_tpu_torch import parallel as P
    from cblosc_tpu_torch.gpu import pipeline
    from cblosc_tpu_torch.utils.timing import synth

    torch.set_num_threads(1)
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    cases = json.loads(sys.argv[4])
    (NB_SH, BS_SH, NB_TR, BS_TR, T), W = json.loads(sys.argv[5]), {world}
    exec(sys.argv[6])
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, W), rank=rank, world_size=W,
        timeout=datetime.timedelta(seconds=60))

    res = {{}}
    mesh = P.make_mesh(W)
    for name, (clevel, shuffle, ts, kind, n, code) in cases.items():
        data = _byte_data(kind, n)
        c = P.compress_chunk(clevel, shuffle, ts, data, mesh, code)
        res["chunk_" + name] = np.frombuffer(c, np.uint8)
        res["roundtrip_" + name] = np.array(P.decompress_chunk(c, mesh) == data)

    x = _sharded_blocks()
    lb = NB_SH // W
    local = torch.from_numpy(x[rank * lb:(rank + 1) * lb].copy())
    slots, cs, off, total = P.compress_blocks_sharded(local, 1, T, T, mesh)
    res.update(sh_slots=slots.numpy(), sh_cs=cs.numpy(), sh_off=off.numpy(),
               sh_total=np.array(int(total)))
    # this rank's framed splits at their offsets of the chunk, decoded
    chunk = pipeline.compact_chunk(slots, cs, off, int(total))
    blocks, err = P.decompress_blocks_sharded(chunk, off + 4, cs, BS_SH // T,
                                              1, T, T, mesh)
    res.update(sh_dec=blocks.numpy(), sh_err=err.numpy())

    y = _train_blocks()
    lb = NB_TR // W
    out1, err1, total1 = P.training_step(
        torch.from_numpy(y[rank * lb:(rank + 1) * lb].copy()), 1, T, T, mesh)
    res.update(tr_out=out1.numpy(), tr_err=err1.numpy(),
               tr_total=np.array(int(total1)))

    mesh2 = P.make_mesh_2d(W, 2)
    b = mesh2.get_local_rank("blocks")
    lb = NB_TR // mesh2.size(0)
    out2, err2, total2 = P.training_step_2d(
        torch.from_numpy(y[b * lb:(b + 1) * lb].copy()), 1, T, T, mesh2)
    res.update(tr2_out=out2.numpy(), tr2_err=err2.numpy(),
               tr2_total=np.array(int(total2)), tr2_coord=np.array(
                   [b, mesh2.get_local_rank("splits")]))

    # every rank but the last holds 4 blocks: 15 in all
    try:
        P.compress_blocks_sharded(local[: 4 if rank < W - 1 else 3], 1, T, T,
                                  mesh)
        res["uneven"] = np.array("no error")
    except ValueError as e:
        res["uneven"] = np.array(str(e))
    np.savez(out, **res)
    dist.destroy_process_group()
""").format(world=WORLD)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 4-rank gloo group once; returns each rank's results."""
    tmp = tmp_path_factory.mktemp("gloo4")
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1]),
           "OMP_NUM_THREADS": "1"}
    shapes = json.dumps([NB_SH, BS_SH, NB_TR, BS_TR, T])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(tmp / "store"),
         str(tmp / f"rank{r}.npz"), json.dumps(BYTE_CASES), shapes, _INPUTS],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}: {errs[r][-3000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def mesh4():
    return jpar.make_mesh(WORLD)


@pytest.mark.parametrize("name", list(BYTE_CASES))
def test_byte_api_matches_jax(ranks, mesh4, name):
    clevel, shuffle, ts, kind, n, code = BYTE_CASES[name]
    data = _byte_data(kind, n)
    want = jpar.compress_chunk(clevel, shuffle, ts, data, mesh4, code)
    if name.endswith("-tail"):      # host-engine blocks and a leftover
        nbytes, _, bs = jb.cbuffer_sizes(want)
        assert bs == BS and (nbytes // bs) % WORLD and nbytes % bs
    for r in range(WORLD):
        assert ranks[r]["chunk_" + name].tobytes() == want, r
        assert bool(ranks[r]["roundtrip_" + name]), r


def test_blocks_sharded_match_jax(ranks, mesh4):
    x = _sharded_blocks()
    slots, cs, off, total = jpar.compress_blocks_sharded(
        jnp.asarray(x), 1, T, T, mesh4)
    rows = NB_SH * T // WORLD
    for r in range(WORLD):
        sl = slice(r * rows, (r + 1) * rows)
        assert np.array_equal(ranks[r]["sh_slots"], np.asarray(slots)[sl])
        assert np.array_equal(ranks[r]["sh_cs"], np.asarray(cs)[sl])
        assert np.array_equal(ranks[r]["sh_off"], np.asarray(off)[sl])
        assert int(ranks[r]["sh_total"]) == int(total)
        lb = NB_SH // WORLD
        assert np.array_equal(ranks[r]["sh_dec"], x[r * lb:(r + 1) * lb])
        assert not ranks[r]["sh_err"].any()


def test_training_step_matches_jax(ranks, mesh4):
    y = _train_blocks()
    out, err, total = jpar.training_step(jnp.asarray(y), 1, T, T, mesh4)
    assert np.array_equal(np.asarray(out), y) and not np.asarray(err).any()
    lb = NB_TR // WORLD
    for r in range(WORLD):
        assert np.array_equal(ranks[r]["tr_out"], y[r * lb:(r + 1) * lb])
        assert not ranks[r]["tr_err"].any()
        assert int(ranks[r]["tr_total"]) == int(total)


def test_training_step_2d_matches_jax(ranks):
    y = _train_blocks()
    mesh2 = jpar.make_mesh_2d(WORLD, 2)
    assert dict(mesh2.shape) == {"blocks": 2, "splits": 2}
    out, err, total = jpar.training_step_2d(jnp.asarray(y), 1, T, T, mesh2)
    assert np.array_equal(np.asarray(out), y) and not np.asarray(err).any()
    lb = NB_TR // 2
    coords = set()
    for r in range(WORLD):
        b, s = ranks[r]["tr2_coord"]
        coords.add((int(b), int(s)))
        assert np.array_equal(ranks[r]["tr2_out"], y[b * lb:(b + 1) * lb])
        assert ranks[r]["tr2_err"].shape == (lb, T // 2)
        assert not ranks[r]["tr2_err"].any()
        assert int(ranks[r]["tr2_total"]) == int(total)
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_uneven_block_count_raises_jax_error(ranks, mesh4):
    x = _sharded_blocks()[:15]
    with pytest.raises(ValueError) as e:
        jpar.compress_blocks_sharded(jnp.asarray(x), 1, T, T, mesh4)
    for r in range(WORLD):
        assert str(ranks[r]["uneven"]) == str(e.value)


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, destroyed afterwards."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_in_process(one_rank):
    mesh = tpar.make_mesh()
    jmesh = jpar.make_mesh(1)
    for name in ("blosclz-tail", "lz4-tail"):
        clevel, shuffle, ts, kind, n, code = BYTE_CASES[name]
        data = _byte_data(kind, n)
        c = tpar.compress_chunk(clevel, shuffle, ts, data, mesh, code)
        assert c == jpar.compress_chunk(clevel, shuffle, ts, data, jmesh, code)
        assert tpar.decompress_chunk(c, mesh) == data
    y = _train_blocks()
    out, err, total = tpar.training_step(torch.from_numpy(y.copy()), 1, T, T,
                                         mesh)
    assert torch.equal(out, torch.from_numpy(y)) and not err.any()
    mesh2 = tpar.make_mesh_2d(1)
    assert mesh2.mesh.shape == (1, 1)
    out2, err2, total2 = tpar.training_step_2d(torch.from_numpy(y.copy()), 1,
                                               T, T, mesh2)
    assert torch.equal(out2, torch.from_numpy(y)) and not err2.any()
    assert int(total2) == int(total)
    with pytest.raises(ValueError):
        tpar.make_mesh(2)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        tpar.make_mesh()
    with pytest.raises(RuntimeError):
        tpar.make_mesh_2d()
    assert not dist.is_initialized()


_ONE_RANK = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np
    import torch.distributed as dist
    from cblosc_tpu_torch import parallel as P
    from cblosc_tpu_torch.utils.timing import synth
    backend, store = sys.argv[1], sys.argv[2]
    clevel, shuffle, ts, kind, n, code = json.loads(sys.argv[3])
    exec(sys.argv[4])
    dist.init_process_group(backend, store=dist.FileStore(store, 1), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    data = _byte_data(kind, n)
    mesh = P.make_mesh()
    c = P.compress_chunk(clevel, shuffle, ts, data, mesh, code)
    assert P.decompress_chunk(c, mesh) == data
    sys.stdout.buffer.write(c)
    dist.destroy_process_group()
""")


@pytest.mark.cuda
def test_one_rank_nccl_chunk_equals_gloo(tmp_path):
    """On the card: a one-rank NCCL group writes the chunk of a one-rank
    gloo group (each in a child process, since a process holds one
    default group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1])}
    outs = []
    for backend in ("nccl", "gloo"):
        r = subprocess.run(
            [sys.executable, "-c", _ONE_RANK, backend, str(tmp_path / backend),
             json.dumps(BYTE_CASES["blosclz-tail"]), _INPUTS],
            capture_output=True, timeout=120, env=env)
        assert r.returncode == 0, r.stderr[-3000:]
        outs.append(r.stdout)
    assert outs[0] == outs[1]
