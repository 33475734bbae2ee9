"""File IO parity of the PyTorch port (``repro_torch.core.io``) with the
JAX package (``repro.core.io``) on the CPU.

Files interchange both ways: an npz saved by either package, compressed
or STORED, loads in the other (with ``mmap=True`` where STORED) with every
buffer byte-identical, dtypes included (uint16 ids; int64 ``indptr`` in
the port, which JAX holds as int32 with x64 off). The legacy fixtures load
in the port as they load in the JAX package. TSV imports are chunk-size
invariant and equal the JAX package's; exports are byte-identical. Every
network comes from ``np.random.default_rng`` with the seed named in its
fixture.
"""

import dataclasses
import gzip
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import io as jio
from repro.core.layers import add_edges as j_add_edges
from repro.core.layers import one_mode_from_edges as j_one_mode
from repro.core.layers import two_mode_from_memberships as j_two_mode
from repro_torch.core import io as tio
from repro_torch.core.convert import network_from_arrays

from _torch_parity import (
    assert_csr_identical,
    assert_layer_identical,
    assert_network_identical,
    network_tree,
    port_network,
)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
N = 300


@pytest.fixture(scope="module")
def jnet():
    """A JAX network with each kind of buffer: an undirected layer, a
    directed valued layer with its inbound CSR, a two-mode layer of uint16
    ids and one of int32 ids (70,000 groups), and attributes of the four
    kinds. Seed 1900."""
    rng = np.random.default_rng(1900)
    net = japi.createnetwork(japi.createnodeset(N))
    net = japi.generate(japi.addlayer(net, "Friends", 1), "Friends", type="er",
                        p=0.03, seed=1)
    src, dst = rng.integers(0, N, (2, 400))
    net = net.with_layer("Follows", j_one_mode(
        N, src, dst, values=rng.random(400).astype(np.float32), directed=True))
    net = japi.generate(japi.addlayer(net, "Clubs", 2), "Clubs", type="2mode",
                        h=20, a=3, seed=2)
    nodes, groups = rng.integers(0, N, 500), rng.integers(0, 70_000, 500)
    net = net.with_layer("Registry", j_two_mode(N, 70_000, nodes, groups))
    net = japi.setnodeattr(net, "age", np.arange(0, N, 2), np.arange(0, N, 2) % 90,
                           kind="int")
    net = japi.setnodeattr(net, "score", [1, 5], [0.5, 2.5], kind="float")
    net = japi.setnodeattr(net, "member", [3], True, kind="bool")
    return japi.setnodeattr(net, "grade", [4, 7], ["A", "B"], kind="char")


def test_the_fixture_holds_both_id_widths(jnet):
    tnet = port_network(jnet)
    assert tnet.layer("Clubs").memb.indices.dtype == torch.uint16
    assert tnet.layer("Registry").memb.indices.dtype == torch.int32
    assert tnet.layer("Follows").in_ is not None


@pytest.mark.parametrize("compress,mmap", [(True, False), (False, False), (False, True)])
def test_jax_file_loads_in_the_port(jnet, tmp_path, compress, mmap):
    path = tmp_path / "j.npz"
    jio.save_network(jnet, path, compress=compress)
    assert_network_identical(tio.load_network(path, mmap=mmap, device="cpu"), jnet)


@pytest.mark.parametrize("compress,mmap", [(True, False), (False, False), (False, True)])
def test_port_file_loads_in_jax(jnet, tmp_path, compress, mmap):
    path = tmp_path / "t.npz"
    tnet = port_network(jnet)
    tio.save_network(tnet, path, compress=compress)
    assert_network_identical(tnet, jio.load_network(path, mmap=mmap))
    assert_network_identical(tio.load_network(path, mmap=mmap, device="cpu"), tnet)


def test_port_manifest_is_the_jax_format(jnet, tmp_path):
    path = tmp_path / "t.npz"
    tio.save_network(port_network(jnet), path, compress=False)
    j = tmp_path / "j.npz"
    jio.save_network(jnet, j, compress=False)
    manifest = json.loads(bytes(np.load(path)["__manifest__"]).decode())
    assert manifest == json.loads(bytes(np.load(j)["__manifest__"]).decode())
    assert manifest["format"] == "threadle-jax/2"
    assert sorted(np.load(path).files) == sorted(np.load(j).files)


@pytest.mark.parametrize("mmap", [False, True])
def test_int64_indptr_is_kept_both_ways(jnet, tmp_path, mmap):
    tree = network_tree(jnet)
    for layer in tree["layers"]:
        for key in ("out", "in", "memb", "members"):
            if layer.get(key) is not None:
                layer[key]["indptr"] = layer[key]["indptr"].astype(np.int64)
    tnet = network_from_arrays(tree, device="cpu")
    path = tmp_path / "wide.npz"
    tio.save_network(tnet, path, compress=not mmap)
    back = tio.load_network(path, mmap=mmap, device="cpu")
    assert back.layer("Clubs").memb.indptr.dtype == torch.int64
    assert back.layer("Clubs").memb.indptr_host.dtype == np.int64
    assert_network_identical(back, tnet)
    # the JAX package reads the same file (x64 off: int32 on its side)
    jback = jio.load_network(path, mmap=mmap)
    for name in tnet.layer_names:
        a, b = tnet.layer(name), jback.layer(name)
        for key in ("out", "memb", "members"):
            if hasattr(a, key):
                np.testing.assert_array_equal(getattr(a, key).indptr_host,
                                              np.asarray(getattr(b, key).indptr))


def test_mutated_network_saves_compacted(jnet, tmp_path):
    jm = j_add_edges(jnet.layer("Clubs"), [1, 2, 3], [0, 4, 25], compact_ratio=None)
    jm = jnet.with_layer("Clubs", jm)
    tm = port_network(jm)
    assert tm.layer("Clubs").memb_ov is not None
    path = tmp_path / "m.npz"
    tio.save_network(tm, path)
    assert_network_identical(tio.load_network(path, device="cpu"), jm.compacted())


def test_legacy_v1_fixture_loads_in_the_port():
    path = FIXTURES / "legacy_threadle_v1.npz"
    assert_network_identical(tio.load_network(path, device="cpu"), jio.load_network(path))


def test_legacy_store_recovers_in_the_port(tmp_path):
    from repro.core import snapshot as jsnap
    from repro_torch.core import snapshot as tsnap

    store = tmp_path / "store"
    shutil.copytree(FIXTURES / "legacy_store", store)
    tnet, tinfo = tsnap.recover(store, device="cpu")
    jnet, jinfo = jsnap.recover(store)
    assert dataclasses.asdict(tinfo) == dataclasses.asdict(jinfo)
    assert tinfo.replayed == 1
    assert_network_identical(tnet.compacted(), jnet.compacted())


def test_mmap_load_refuses_a_compressed_file(jnet, tmp_path):
    path = tmp_path / "c.npz"
    jio.save_network(jnet, path, compress=True)
    with pytest.raises(ValueError, match="compressed"):
        tio.load_network(path, mmap=True, device="cpu")


def test_unknown_format_is_refused(tmp_path):
    path = tmp_path / "x.npz"
    manifest = {"format": "threadle-jax/9", "n_nodes": 1, "layers": [], "attrs": []}
    np.savez(path, __manifest__=np.frombuffer(json.dumps(manifest).encode(), np.uint8))
    with pytest.raises(ValueError, match="unknown file format"):
        tio.load_network(path, device="cpu")


# ---------------------------------------------------------------------------
# Text IO
# ---------------------------------------------------------------------------


def _edge_rows(seed: int, rows: int = 120, n: int = 40) -> str:
    """TSV edge rows with duplicates, both orientations and a blank line."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, (2, rows))
    vals = np.round(rng.random(rows) * 10, 3)
    lines = [f"{a}\t{b}\t{v}" for a, b, v in zip(src, dst, vals)]
    lines[5] = lines[3]  # an exact duplicate
    a, b, _ = lines[7].split("\t")
    lines[8] = f"{b}\t{a}\t9.5"  # the mirror with another value
    return "\n".join(lines[:60]) + "\n\n" + "\n".join(lines[60:]) + "\n"


@pytest.mark.parametrize("chunk_rows", [1, 7, 64, 1_000_000])
@pytest.mark.parametrize("directed", [False, True])
def test_tsv_import_is_chunk_size_invariant_and_equals_jax(tmp_path, chunk_rows, directed):
    path = tmp_path / "e.tsv"
    path.write_text(_edge_rows(1901))
    kw = dict(mode=1, directed=directed, valued=True, chunk_rows=chunk_rows)
    got = tio.import_layer_tsv(path, 40, device="cpu", **kw)
    assert_layer_identical(got, jio.import_layer_tsv(path, 40, **kw))
    whole = tio.import_layer_tsv(path, 40, device="cpu", mode=1, directed=directed,
                                 valued=True)
    assert_layer_identical(got, whole)


def test_gz_tsv_import_equals_plain(tmp_path):
    text = _edge_rows(1902)
    plain, packed = tmp_path / "e.tsv", tmp_path / "e.tsv.gz"
    plain.write_text(text)
    with gzip.open(packed, "wt") as f:
        f.write(text)
    got = tio.import_layer_tsv(packed, 40, valued=True, chunk_rows=16, device="cpu")
    assert_layer_identical(got, tio.import_layer_tsv(plain, 40, valued=True, device="cpu"))
    assert_layer_identical(got, jio.import_layer_tsv(packed, 40, valued=True, chunk_rows=16))


def test_two_mode_import_with_unknown_hyperedge_count(tmp_path):
    rng = np.random.default_rng(1903)
    nodes, groups = rng.integers(0, 50, 200), rng.integers(0, 70_000, 200)
    path = tmp_path / "m.tsv"
    path.write_text("".join(f"{a}\t{b}\n" for a, b in zip(nodes, groups)))
    got = tio.import_layer_tsv(path, 50, mode=2, chunk_rows=33, device="cpu")
    assert got.n_hyperedges == int(groups.max()) + 1
    assert_layer_identical(got, jio.import_layer_tsv(path, 50, mode=2, chunk_rows=33))


def test_truncated_tsv_row_raises(tmp_path):
    path = tmp_path / "t.tsv"
    path.write_text("0\t1\n2\t3\n4\n")
    with pytest.raises(tio.TruncatedFileError) as err:
        tio.import_layer_tsv(path, 10, device="cpu")
    assert err.value.lineno == 3


def test_truncated_gzip_stream_raises(tmp_path):
    path = tmp_path / "t.tsv.gz"
    with gzip.open(path, "wt") as f:
        f.write("".join(f"{i}\t{i + 1}\n" for i in range(2000)))
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])
    with pytest.raises(tio.TruncatedFileError, match="compressed stream"):
        tio.import_layer_tsv(path, 3000, device="cpu")


def test_missing_value_raises_and_default_fills(tmp_path):
    path = tmp_path / "v.tsv"
    path.write_text("0\t1\t2.5\n1\t2\n2\t3\t\n")
    with pytest.raises(ValueError, match="no value column"):
        tio.import_layer_tsv(path, 5, valued=True, device="cpu")
    got = tio.import_layer_tsv(path, 5, valued=True, default_value=7.0, device="cpu")
    assert_layer_identical(got, jio.import_layer_tsv(path, 5, valued=True,
                                                     default_value=7.0))
    assert sorted(got.out.values.tolist()) == [2.5, 2.5, 7.0, 7.0, 7.0, 7.0]


@pytest.mark.parametrize("shape", ["header", "two-column"])
def test_load_attrs_tsv_equals_jax(tmp_path, shape):
    path = tmp_path / "a.tsv"
    if shape == "header":
        path.write_text("node\tincome:float\temployed:bool\tgrade:char\n"
                        "0\t10.5\ttrue\tA\n1\t\tfalse\t\n2\t99.0\t\tC\n")
        kw = {}
    else:
        path.write_text("3\t17\n1\t4\n\n8\t-2\n")
        kw = {"name": "size", "kind": "int"}
    got, want = tio.load_attrs_tsv(path, **kw), jio.load_attrs_tsv(path, **kw)
    assert [(n, k) for n, k, _, _ in got] == [(n, k) for n, k, _, _ in want]
    for (_, _, gi, gv), (_, _, wi, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert gv.dtype == wv.dtype
        np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("layer", ["Friends", "Follows", "Clubs", "Registry"])
def test_export_is_byte_identical(jnet, tmp_path, layer):
    tpath, jpath = tmp_path / "t.tsv", tmp_path / "j.tsv"
    tio.export_layer_tsv(port_network(jnet), layer, tpath)
    jio.export_layer_tsv(jnet, layer, jpath)
    assert tpath.read_bytes() == jpath.read_bytes()
    assert tpath.stat().st_size > 0


def test_export_of_an_overlay_layer_is_byte_identical(jnet, tmp_path):
    jm = jnet.with_layer("Follows", j_add_edges(
        jnet.layer("Follows"), [0, 1, 2], [5, 6, 7], values=[1.5, 2.5, 3.5],
        compact_ratio=None))
    tm = port_network(jm)
    assert tm.layer("Follows").out_ov is not None
    tpath, jpath = tmp_path / "t.tsv.gz", tmp_path / "j.tsv.gz"
    tio.export_layer_tsv(tm, "Follows", tpath)
    jio.export_layer_tsv(jm, "Follows", jpath)
    assert gzip.decompress(tpath.read_bytes()) == gzip.decompress(jpath.read_bytes())
    back = tio.import_layer_tsv(tpath, N, directed=True, valued=True, device="cpu")
    assert_csr_identical(back.out, jm.compacted().layer("Follows").out)
