"""PyTorch port, storage layer: CSR builders, device queries, generators,
the overlay read merge, and the port's import and device rules.

Tolerance: none — every buffer and query result must be bit-identical to
the JAX package's (same dtype, same bytes). Inputs come from
``np.random.default_rng`` with the seed named in each test.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import generators as jgen
from repro.core import layers as jlayers
from repro.core import overlay as jov
from repro_torch.core import csr as tcsr
from repro_torch.core import generators as tgen
from repro_torch.core import layers as tlayers
from repro_torch.core import overlay as tov

from _torch_parity import (
    assert_csr_identical,
    assert_same,
    port_layer,
)

REPO = Path(__file__).resolve().parents[1]
POLICIES = {
    "default": (jcsr.DEFAULT_POLICY, tcsr.DEFAULT_POLICY),
    "int32": (jcsr.POLICY_INT32, tcsr.POLICY_INT32),
}


def _coo(seed, n_rows, n_cols, nnz):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, n_cols, nnz)
    vals = rng.random(nnz).astype(np.float32)
    return rows, cols, vals


# ---------------------------------------------------------------------------
# Builders: byte identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("n_cols", [50, 70_000])  # uint16 and int32 indices
@pytest.mark.parametrize("mode", ["dedup", "sum", "valued_dedup", "raw"])
def test_csr_from_coo_byte_identity(policy, n_cols, mode):
    jp, tp = POLICIES[policy]
    rows, cols, vals = _coo(11, 40, n_cols, 900)  # seed 11, duplicates likely
    kw = {
        "dedup": {"dedup": True},
        "sum": {"values": vals, "sum_duplicates": True},
        "valued_dedup": {"values": vals, "dedup": True},
        "raw": {"dedup": False},
    }[mode]
    j = jcsr.csr_from_coo(rows, cols, 40, n_cols, policy=jp, **kw)
    t = tcsr.csr_from_coo(rows, cols, 40, n_cols, policy=tp, device="cpu", **kw)
    assert_csr_identical(t, j)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_chunked_build_and_transpose_identity(policy):
    jp, tp = POLICIES[policy]
    rows, cols, vals = _coo(12, 300, 80, 5000)  # seed 12
    chunks = [(rows[s:s + 700], cols[s:s + 700], vals[s:s + 700])
              for s in range(0, rows.size, 700)]
    j = jcsr.csr_from_coo_chunks(chunks, 300, 80, policy=jp)
    t = tcsr.csr_from_coo_chunks(chunks, 300, 80, policy=tp, device="cpu")
    assert_csr_identical(t, j)
    assert_csr_identical(
        tcsr.csr_transpose(t, policy=tp), jcsr.csr_transpose(j, policy=jp)
    )
    assert t.nbytes == j.nbytes and t.max_degree() == j.max_degree()


def test_csr_empty_identity():
    for valued in (False, True):
        assert_csr_identical(
            tcsr.csr_empty(5, 9, valued=valued, device="cpu"),
            jcsr.csr_empty(5, 9, valued=valued),
        )


@pytest.mark.parametrize("kind", ["er", "ws", "ba", "2mode"])
def test_generators_byte_identity(kind):
    n = 400
    if kind == "er":
        j, t = jgen.erdos_renyi(n, 0.02, seed=3), tgen.erdos_renyi(n, 0.02, seed=3, device="cpu")
    elif kind == "ws":
        j, t = jgen.watts_strogatz(n, 6, 0.2, seed=3), tgen.watts_strogatz(n, 6, 0.2, seed=3, device="cpu")
    elif kind == "ba":
        j, t = jgen.barabasi_albert(n, 3, seed=3), tgen.barabasi_albert(n, 3, seed=3, device="cpu")
    else:
        j, t = jgen.random_two_mode(n, 30, 4, seed=3), tgen.random_two_mode(n, 30, 4, seed=3, device="cpu")
    if kind == "2mode":
        assert_csr_identical(t.memb, j.memb)
        assert_csr_identical(t.members, j.members)
        assert (t.max_memberships, t.max_hyperedge_size) == (
            j.max_memberships, j.max_hyperedge_size)
        assert t.equivalent_projected_edges() == j.equivalent_projected_edges()
    else:
        assert_csr_identical(t.out, j.out)
        assert t.n_edges == j.n_edges


def test_directed_one_mode_inbound_identity():
    rows, cols, vals = _coo(13, 200, 200, 1500)  # seed 13
    j = jlayers.one_mode_from_edges(200, rows, cols, values=vals, directed=True)
    t = tlayers.one_mode_from_edges(
        200, rows, cols, values=vals, directed=True, device="cpu"
    )
    assert_csr_identical(t.out, j.out)
    assert_csr_identical(t.in_, j.in_)


# ---------------------------------------------------------------------------
# Device queries
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def csr_pair():
    rows, cols, vals = _coo(14, 120, 60, 1500)  # seed 14; uint16 indices
    j = jcsr.csr_from_coo(rows, cols, 120, 60, values=vals)
    t = tcsr.csr_from_coo(rows, cols, 120, 60, values=vals, device="cpu")
    return j, t


def test_contains_and_value_at_parity(csr_pair):
    j, t = csr_pair
    rng = np.random.default_rng(15)  # seed 15; ids past both ends clip
    r = rng.integers(-3, 125, 600).astype(np.int32)
    c = rng.integers(0, 62, 600).astype(np.int32)
    assert_same(tcsr.csr_contains(t, torch.from_numpy(r), torch.from_numpy(c)),
                jcsr.csr_contains(j, jnp.asarray(r), jnp.asarray(c)))
    assert_same(tcsr.csr_value_at(t, torch.from_numpy(r), torch.from_numpy(c)),
                jcsr.csr_value_at(j, jnp.asarray(r), jnp.asarray(c)))


@pytest.mark.parametrize("max_len", [1, 8, 40])
def test_row_gather_parity(csr_pair, max_len):
    j, t = csr_pair
    r = np.random.default_rng(16).integers(-2, 123, (7, 9)).astype(np.int32)  # seed 16
    tv, tm = tcsr.csr_row_gather(t, torch.from_numpy(r), max_len)
    jv, jm = jcsr.csr_row_gather(j, jnp.asarray(r), max_len)
    assert_same(tv, jv)
    assert_same(tm, jm)


def test_bsearch_range_parity(csr_pair):
    j, t = csr_pair
    rng = np.random.default_rng(17)  # seed 17
    lo = rng.integers(0, 500, 300).astype(np.int32)
    hi = (lo + rng.integers(0, 40, 300)).astype(np.int32)
    tgt = rng.integers(0, 60, 300).astype(np.int32)
    tp, tf = tcsr.bsearch_range(t.indices, torch.from_numpy(lo),
                                torch.from_numpy(hi), torch.from_numpy(tgt))
    jp, jf = jcsr.bsearch_range(j.indices, jnp.asarray(lo), jnp.asarray(hi),
                                jnp.asarray(tgt))
    assert_same(tp, jp)
    assert_same(tf, jf)


def test_sorted_isin_and_padded_unique_parity(csr_pair):
    j, t = csr_pair
    rng = np.random.default_rng(18)  # seed 18
    ra = rng.integers(0, 120, 50).astype(np.int32)
    rb = rng.integers(0, 120, 50).astype(np.int32)
    ta, tam = tcsr.csr_row_gather(t, torch.from_numpy(ra), 30)
    tb, tbm = tcsr.csr_row_gather(t, torch.from_numpy(rb), 25)
    ja, jam = jcsr.csr_row_gather(j, jnp.asarray(ra), 30)
    jb, jbm = jcsr.csr_row_gather(j, jnp.asarray(rb), 25)
    assert_same(tcsr.sorted_isin(ta, tam, tb, tbm),
                jcsr.sorted_isin(ja, jam, jb, jbm))
    vals = rng.integers(0, 20, (12, 33)).astype(np.int32)
    valid = rng.random((12, 33)) < 0.7
    tu, tm = tcsr.padded_unique(torch.from_numpy(vals), torch.from_numpy(valid))
    ju, jm = jcsr.padded_unique(jnp.asarray(vals), jnp.asarray(valid))
    assert_same(tu, ju)
    assert_same(tm, jm)


# ---------------------------------------------------------------------------
# Overlay read merge (a live DeltaOverlay made by the JAX package)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def overlay_layers():
    rng = np.random.default_rng(19)  # seed 19
    base1 = jlayers.one_mode_from_edges(
        300, rng.integers(0, 300, 2000), rng.integers(0, 300, 2000),
        values=rng.random(2000).astype(np.float32),
    )
    one = jlayers.add_edges(
        base1, rng.integers(0, 300, 40), rng.integers(0, 300, 40),
        values=rng.random(40).astype(np.float32), compact_ratio=None,
    )
    one = jlayers.delete_edges(one, rng.integers(0, 300, 20),
                               rng.integers(0, 300, 20), compact_ratio=None)
    base2 = jlayers.two_mode_from_memberships(
        300, 40, rng.integers(0, 300, 1500), rng.integers(0, 40, 1500)
    )
    two = jlayers.add_edges(base2, rng.integers(0, 300, 30),
                            rng.integers(0, 44, 30), compact_ratio=None)
    assert one.out_ov is not None and two.memb_ov is not None
    return one, two


def test_overlay_read_merge_parity(overlay_layers):
    one, two = overlay_layers
    t1, t2 = port_layer("one", one), port_layer("two", two)
    rng = np.random.default_rng(20)  # seed 20
    r = rng.integers(0, 300, 500).astype(np.int32)
    c = rng.integers(0, 300, 500).astype(np.int32)
    rt, ct, rj, cj = (torch.from_numpy(r), torch.from_numpy(c),
                      jnp.asarray(r), jnp.asarray(c))
    assert_same(tov.eff_contains(t1.out, t1.out_ov, rt, ct),
                jov.eff_contains(one.out, one.out_ov, rj, cj))
    assert_same(tov.eff_value_at(t1.out, t1.out_ov, rt, ct),
                jov.eff_value_at(one.out, one.out_ov, rj, cj))
    for tl, jl, tb, jb in ((t1, one, t1.out, one.out), (t2, two, t2.memb, two.memb)):
        tov_, jov_ = (tl.out_ov, jl.out_ov) if tl.mode == 1 else (tl.memb_ov, jl.memb_ov)
        tv, tm = tov.eff_row_gather(tb, tov_, rt, 20)
        jv, jm = jov.eff_row_gather(jb, jov_, rj, 20)
        assert_same(tv, jv)
        assert_same(tm, jm)
        assert_same(tov.eff_degrees(tb, tov_), jov.eff_degrees(jb, jov_))
        assert_same(tov.eff_host_degrees(tb, tov_, r), jov.eff_host_degrees(jb, jov_, r))
        assert_same(tov.eff_host_degree_table(tb, tov_),
                    jov.eff_host_degree_table(jb, jov_))
        assert tov.eff_max_degree(tb, tov_) == jov.eff_max_degree(jb, jov_)
        assert tov.eff_nnz(tb, tov_) == jov.eff_nnz(jb, jov_)
    assert t2.n_hyperedges == two.n_hyperedges
    assert t2.equivalent_projected_edges() == two.equivalent_projected_edges()
    assert_same(t2.hyperedge_sizes(), two.hyperedge_sizes())
    assert t1.nbytes == one.nbytes and t2.nbytes == two.nbytes


# ---------------------------------------------------------------------------
# Device and import rules
# ---------------------------------------------------------------------------


def test_no_device_and_no_cuda_raises(monkeypatch):
    from repro_torch.core import api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.createnodeset(10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.createnetwork(10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcsr.csr_empty(3, 3)
    assert api.createnetwork(10, device="cpu").device.type == "cpu"


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    return mods


def test_port_never_imports_jax_or_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for m in _imported_modules(f):
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f} imports {m}"
    # and transitively: importing the whole port pulls in neither
    code = (
        "import sys, repro_torch.core.api, repro_torch.core.convert, "
        "repro_torch.kernels.ops; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
