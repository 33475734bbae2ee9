"""Durability parity of the PyTorch port (``repro_torch.core.wal``,
``repro_torch.core.snapshot``) with the JAX package on the CPU.

The same op sequence writes a byte-identical ``wal.log`` in both packages;
torn tails scan and truncate alike; a store written by either package
recovers in the other to the same buffers; ``DurableStore`` fails closed
(an ``os.fsync`` that raises rejects the op and leaves the network as it
was); and a process killed by SIGKILL after an acknowledged append
recovers that op. Networks come from ``np.random.default_rng`` with the
seed named in each fixture.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import snapshot as jsnap
from repro.core import wal as jwal
from repro_torch.core import snapshot as tsnap
from repro_torch.core import wal as twal

from _torch_parity import assert_network_identical, port_network

N = 150
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jnet():
    """A JAX network with an undirected layer, a two-mode layer and an
    attribute (seed 1920)."""
    net = japi.createnetwork(japi.createnodeset(N))
    net = japi.generate(japi.addlayer(net, "Random", 1), "Random", type="er",
                        p=0.05, seed=1920)
    net = japi.generate(japi.addlayer(net, "Clubs", 2), "Clubs", type="2mode",
                        h=12, a=3, seed=1921)
    return japi.setnodeattr(net, "age", np.arange(N), np.arange(N) % 80, kind="int")


def _ops(wal, form):
    """The op sequence, arguments given as lists, numpy arrays or tensors."""
    rng = np.random.default_rng(1922)
    a, b = rng.integers(0, N, (2, 40))
    vals = rng.random(40).astype(np.float32)
    conv = {"list": lambda x: x.tolist(), "numpy": lambda x: x,
            "tensor": torch.from_numpy}[form]
    if wal is jwal:
        conv = {"list": lambda x: x.tolist()}.get(form, lambda x: x)
    return [
        wal.make_add_edges_op("Random", conv(a), conv(b)),
        wal.make_delete_edges_op("Random", conv(a[:5]), conv(b[:5])),
        wal.make_add_edges_op("Clubs", conv(a[:6]), conv(b[:6] % 20)),
        wal.make_set_attr_op("age", conv(a[:4]), conv(b[:4]), kind="int"),
        wal.make_set_attr_op("grade", [1, 2], ["A", "B"], kind="char"),
        wal.make_import_layer_op("Follows", conv(a), conv(b), directed=True,
                                 values=conv(vals)),
        wal.make_import_layer_op("Teams", conv(a[:10]), conv(b[:10] % 7), mode=2),
        wal.make_delete_layer_op("Teams"),
    ]


@pytest.mark.parametrize("form", ["list", "numpy", "tensor"])
def test_wal_is_byte_identical(tmp_path, form):
    paths = {}
    for name, wal in (("j", jwal), ("t", twal)):
        paths[name] = tmp_path / f"{name}.log"
        with wal.WriteAheadLog.create(paths[name], fsync=False) as log:
            lsns = [log.append(op) for op in _ops(wal, form)]
        assert lsns == list(range(8))
    assert paths["t"].read_bytes() == paths["j"].read_bytes()


@pytest.mark.parametrize("cut", ["header", "payload", "crc"])
def test_torn_tail_scans_and_truncates_alike(tmp_path, cut):
    path = tmp_path / "wal.log"
    with twal.WriteAheadLog.create(path, fsync=False) as log:
        for op in _ops(twal, "list"):
            log.append(op)
    records, end, torn = twal.scan(path)
    assert not torn and end == path.stat().st_size
    last = records[-1]
    data = bytearray(path.read_bytes())
    if cut == "header":
        data = data[: last.offset + 5]
    elif cut == "payload":
        data = data[: (last.offset + last.end_offset) // 2]
    else:
        data[last.end_offset - 2] ^= 0xFF
    path.write_bytes(bytes(data))
    t_records, t_end, t_torn = twal.scan(path)
    j_records, j_end, j_torn = jwal.scan(path)
    assert t_torn and j_torn and t_end == j_end == last.offset
    assert [r.op for r in t_records] == [r.op for r in j_records]
    assert len(t_records) == len(records) - 1
    log = twal.WriteAheadLog.open(path, fsync=False)
    assert log.truncated_bytes == len(data) - last.offset
    assert log.last_lsn == last.lsn - 1
    log.close()
    assert path.stat().st_size == last.offset
    assert not twal.scan(path)[2]


def _store(snap, wal, net, path, form):
    store = snap.DurableStore.create(path, net, fsync=False)
    for op in _ops(wal, form):
        store.apply(op)
    store.close()
    return store.net


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_recovers_in_the_other_package(jnet, tmp_path, writer):
    store = tmp_path / "store"
    if writer == "jax":
        _store(jsnap, jwal, jnet, store, "numpy")
    else:
        _store(tsnap, twal, port_network(jnet), store, "tensor")
    tnet, tinfo = tsnap.recover(store, device="cpu")
    j_rec, jinfo = jsnap.recover(store)
    assert dataclasses.asdict(tinfo) == dataclasses.asdict(jinfo)
    assert tinfo.replayed == 8 and tinfo.last_lsn == 7
    assert_network_identical(tnet, j_rec)
    assert tnet.layer_names == ("Random", "Clubs", "Follows")


def test_replay_names_the_failing_record(jnet, tmp_path):
    store = tmp_path / "store"
    tsnap.DurableStore.create(store, port_network(jnet), fsync=False).close()
    with twal.WriteAheadLog.open(store / tsnap.WAL_NAME, fsync=False) as log:
        log.append(twal.make_add_edges_op("Missing", [1], [2]))
    with pytest.raises(twal.WALReplayError, match="lsn=0"):
        tsnap.recover(store, device="cpu")


def test_store_fails_closed_when_fsync_raises(jnet, tmp_path, monkeypatch):
    store = tsnap.DurableStore.create(tmp_path / "store", port_network(jnet))
    first = store.apply(twal.make_add_edges_op("Random", [1], [2]))
    real = os.fsync

    def broken(fd):
        raise OSError(5, "injected I/O error")

    monkeypatch.setattr(os, "fsync", broken)
    with pytest.raises(twal.WALWriteError, match="lsn=1"):
        store.apply(twal.make_add_edges_op("Random", [3], [4]))
    assert store.net is first and store.last_lsn == 0
    monkeypatch.setattr(os, "fsync", real)
    assert [r.lsn for r in twal.scan(tmp_path / "store" / tsnap.WAL_NAME)[0]] == [0]
    store.apply(twal.make_add_edges_op("Random", [5], [6]))
    store.close()
    rec, info = tsnap.recover(tmp_path / "store", device="cpu")
    assert info.replayed == 2
    assert not bool(rec.layer("Random").check_edge(torch.tensor([3]), torch.tensor([4]))[0])
    assert bool(rec.layer("Random").check_edge(torch.tensor([5]), torch.tensor([6]))[0])


def test_snapshot_and_compact_keep_the_state(jnet, tmp_path):
    path = tmp_path / "store"
    store = tsnap.DurableStore.create(path, port_network(jnet), snapshot_every=3,
                                      fsync=False)
    for op in _ops(twal, "numpy")[:5]:
        store.apply(op)
    freed = store.compact(keep_snapshots=1)
    assert freed > 0 and len(tsnap.list_snapshots(path)) == 1
    store.apply(twal.make_add_edges_op("Clubs", [9], [11]))
    want = store.net
    store.close()
    rec, info = tsnap.recover(path, device="cpu")
    assert info.replayed == 1
    assert_network_identical(rec.compacted(), want.compacted())


def test_sigkill_after_an_acknowledged_append_recovers_the_op(jnet, tmp_path):
    """A child process applies three ops to a store and is killed by
    SIGKILL right after the third op's append returned (durable, not yet
    committed in memory): recovery replays all three."""
    path = tmp_path / "store"
    tsnap.DurableStore.create(path, port_network(jnet), fsync=True).close()
    child = textwrap.dedent(f"""
        import os, signal, sys
        sys.path.insert(0, {str(REPO / "src")!r})
        from repro_torch.core import snapshot, wal
        store = snapshot.DurableStore.open({str(path)!r}, device="cpu")
        real = store._wal.append
        def append(op):
            lsn = real(op)
            if lsn == 2:
                os.kill(os.getpid(), signal.SIGKILL)
            return lsn
        store._wal.append = append
        for i in range(4):
            store.apply(wal.make_add_edges_op("Random", [i], [100 + i]))
    """)
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, timeout=120)
    assert proc.returncode == -9, proc.stderr.decode()[-2000:]
    rec, info = tsnap.recover(path, device="cpu")
    assert info.replayed == 3 and info.last_lsn == 2 and info.torn_bytes == 0
    u, v = torch.tensor([0, 1, 2, 3]), torch.tensor([100, 101, 102, 103])
    before = port_network(jnet).layer("Random").check_edge(u, v).tolist()
    assert rec.layer("Random").check_edge(u, v).tolist() == [True] * 3 + before[3:]
