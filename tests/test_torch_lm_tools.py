"""PyTorch port, the LM tools: the shape matrix, the analytic step models,
the HLO collective parser, the sharding policy and meshes as descriptions,
the dry run on the meta device, and the trainer under a one-card policy,
against the JAX package on the CPU.

Everything here is integers, strings or the same floating-point formulas
in the same order, so the two packages must agree exactly; the analytic
FLOPs and bytes are compared to 1e-12 relative. The JAX side's meshes are
stand-ins with the reference meshes' ``.shape`` and ``.axis_names``, the
only attributes ``prune_spec`` and ``make_policy`` read (conftest pins one
CPU device, and ``repro.launch.dryrun`` would force 512 host devices: it
is imported with the environment restored after it). The trainer test
takes a narrow qwen3 (2 layers, d_model 32, f32), seeded by torch.
"""

import dataclasses
import json
import math
import os
import types

import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.launch import mesh as jmesh
from repro.models import sharding as jsharding
from repro.models.model import Model as JModel
from repro.perf import analytic as janalytic
from repro.perf import hlo_analysis as jhlo
from repro_torch.configs import all_arch_names, get_config
from repro_torch.configs import shapes
from repro_torch.data import pipeline
from repro_torch.launch import dryrun, mesh
from repro_torch.models import sharding
from repro_torch.models.convert import params_to_jax
from repro_torch.models.model import Model
from repro_torch.perf import analytic, hlo_analysis
from repro_torch.train.optimizer import AdamWConfig, tree_leaves
from repro_torch.train.train_loop import Trainer, TrainerConfig

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "collectives_loop.hlo.txt")
ARCHS = all_arch_names()
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
REL = 1e-12


@pytest.fixture(scope="module")
def jdryrun():
    """``repro.launch.dryrun``, imported after the JAX backend is up and
    with the XLA_FLAGS its import sets taken back, so no later process of
    this pytest run starts with 512 forced host devices."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jd


def jax_mesh(name):
    """A stand-in of the reference mesh: its ``.shape`` and ``.axis_names``."""
    sizes, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, sizes)), axis_names=axes)


def port_mesh(name):
    return mesh.make_production_mesh(multi_pod=name == "multi")


def close(a, b):
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


# ---------------------------------------------------------------------------
# shapes, analytic, HLO
# ---------------------------------------------------------------------------


def test_shape_matrix_equal():
    assert {k: vars(v) for k, v in shapes.SHAPES.items()} == {
        k: vars(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.SUBQUADRATIC == jshapes.SUBQUADRATIC
    cells = list(shapes.all_cells(include_skipped=True))
    assert cells == list(jshapes.all_cells(include_skipped=True))
    assert list(shapes.all_cells()) == list(jshapes.all_cells())
    assert len(cells) == 40 and sum(skip for *_, skip in cells) == 8
    for arch, shape, _ in cells:
        assert shapes.cell_applicable(arch, shape) == jshapes.cell_applicable(arch, shape)


@pytest.mark.parametrize("arch", all_arch_names())
def test_step_flops_and_hbm_bytes_equal(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in shapes.SHAPES:
        got, want = analytic.step_flops(cfg, shape), janalytic.step_flops(jcfg, shape)
        assert got.keys() == want.keys()
        assert all(close(got[k], want[k]) for k in got), (shape, got, want)
        for chips in (256, 512):
            for accum in (1, 4):
                assert close(analytic.step_hbm_bytes(cfg, shape, chips, accum),
                             janalytic.step_hbm_bytes(jcfg, shape, chips, accum))


def test_analytic_constants_are_the_h100s():
    assert analytic.CARD.startswith("NVIDIA H100")
    assert (analytic.PEAK_FLOPS, analytic.HBM_BW) == (989e12, 3.35e12)
    assert analytic.roofline_ms(989e12, 0.0) == pytest.approx(1000.0)
    assert analytic.roofline_ms(0.0, 3.35e12) == pytest.approx(1000.0)


def test_analyze_collectives_equal_on_a_loop():
    """A while loop of 12 trips (its condition compares against the
    constant 12) whose body all-reduces 1,024 f32 and calls a computation
    that all-gathers bf16[1024,256]; ENTRY all-reduces once more."""
    text = open(FIXTURE).read()
    got = hlo_analysis.analyze_collectives(text)
    assert got == jhlo.analyze_collectives(text)
    assert got["by_type"]["all-gather"]["count"] == 12
    assert got["by_type"]["all-gather"]["result_bytes"] == 12 * 1024 * 256 * 2
    assert got["by_type"]["all-reduce"]["count"] == 13
    assert got["wire_bytes_per_device"] == 12 * 1024 * 256 * 2 + 2 * 13 * 4096
    assert got["n_computations"] == 5


# ---------------------------------------------------------------------------
# the policy as a description
# ---------------------------------------------------------------------------

_PRUNE_CASES = [
    ((256, 4096), (("pod", "data"), "model"), False),
    ((1, 4096), (("pod", "data"), None), False),
    ((2, 7), (("pod", "data"), "model"), False),
    ((8, 128), ("model", None), False),
    ((56, 128), (None, "model"), True),
    ((8,), ("model", "data"), True),
    ((32, 16, 5), ("data", ("data", "model"), "model"), False),
]


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("shape,entries,uneven", _PRUNE_CASES)
def test_prune_spec_equal(name, shape, entries, uneven):
    m = port_mesh(name)
    entries = tuple(tuple(a for a in e if a in m.axis_names) or None
                    if isinstance(e, tuple) else e for e in entries)
    entries = tuple(e if e is None or isinstance(e, tuple) or e in m.axis_names
                    else None for e in entries)
    got = sharding.prune_spec(m, shape, entries, uneven)
    assert got == tuple(jsharding.prune_spec(jax_mesh(name), shape, entries, uneven))


def test_production_and_host_meshes():
    assert port_mesh("single").shape == {"data": 16, "model": 16}
    assert port_mesh("multi").shape == {"pod": 2, "data": 16, "model": 16}
    assert port_mesh("multi").size == 512
    host = mesh.make_host_mesh(4, model=2)
    assert host.shape == {"data": 2, "model": 2}
    assert mesh.make_host_mesh(1).sizes == (1, 1)
    with pytest.raises(ValueError):
        mesh.make_host_mesh(3, model=2)


def _jax_tree_names(state: dict, cfg) -> dict:
    """{JAX tree path: [port names]}: the port's names carried through
    ``convert.params_to_jax`` as the indices of a stand-in tree."""
    names = list(state)
    idx = {n: torch.tensor(i) for i, n in enumerate(names)}
    out = {}
    for path, leaf in tree_leaves(params_to_jax(idx, cfg)):
        out["/".join(path)] = [names[int(i)] for i in leaf.reshape(-1)]
    return out


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_policy_equal(arch, name):
    """make_policy's fields, and each parameter's spec under it: the port's
    name reaches the rule of the JAX tree path it comes from, and a leaf
    the JAX package stacks over the scanned groups has its spec with the
    stack's leading None taken off."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    policy = mesh.make_policy(port_mesh(name), cfg)
    jpolicy = jmesh.make_policy(jax_mesh(name), jcfg)
    for field in ("dp", "tp", "shard_cache_seq", "seq_parallel"):
        assert getattr(policy, field) == getattr(jpolicy, field), field
    model = Model(cfg, device="meta")
    specs = sharding.param_specs(model, policy)
    jshape = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    jspecs = {
        "/".join(str(getattr(p, "key", p)) for p in path): tuple(s)
        for path, s in jax.tree_util.tree_flatten_with_path(
            jsharding.param_specs(jshape, jpolicy))[0]}
    mapping = _jax_tree_names(dict(model.named_parameters()), cfg)
    assert set(mapping) == set(jspecs)
    for path, ports in mapping.items():
        want = jspecs[path]
        if path.startswith("groups/") and want:
            assert want[0] is None
            want = want[1:]
        for port_name in ports:
            assert specs[port_name] == want, (path, port_name)


@pytest.mark.parametrize("name", MESHES)
def test_default_accum_and_input_specs_equal(jdryrun, name):
    for arch, shape in shapes.all_cells():
        cfg, jcfg = get_config(arch), jget_config(arch)
        policy = mesh.make_policy(port_mesh(name), cfg)
        jpolicy = jmesh.make_policy(jax_mesh(name), jcfg)
        assert dryrun.default_accum(cfg, shape, policy) == jdryrun.default_accum(
            jcfg, shape, jpolicy), (arch, shape)
        got, want = dryrun.input_specs(cfg, shape), jdryrun.input_specs(jcfg, shape)
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (arch, shape, k)
            assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)


def test_policy_constrains_on_one_card_and_refuses_more():
    x = torch.zeros(2, 3, 4)
    one = mesh.make_policy(mesh.make_host_mesh(1), get_config("qwen3-1.7b"))
    assert one.one_card
    for f in (one.act_bsd, one.act_bsf, one.act_logits, one.cache):
        assert f(x) is x
    assert sharding.MeshPolicy().act_bsd(x) is x
    big = mesh.make_policy(port_mesh("single"), get_config("qwen3-1.7b"))
    with pytest.raises(NotImplementedError, match="multi-card path"):
        big.act_bsd(x)
    with sharding.use_policy(one):
        assert sharding.active_policy() is one
    assert sharding.active_policy() == sharding.MeshPolicy()


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def _jax_param_bytes(jcfg, jpolicy, m) -> int:
    shape = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    specs = jsharding.param_specs(shape, jpolicy)
    total = 0
    for leaf, spec in zip(jax.tree.leaves(shape), jax.tree.leaves(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))):
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // math.prod(
            jsharding._axis_size(m, e) for e in spec)
    return total


@pytest.mark.parametrize("name", MESHES)
def test_dryrun_cells_on_the_meta_device(tmp_path, name):
    """run_cell writes the reference's keys and no XLA field; a card's
    parameter bytes equal the JAX specs' count over the JAX tree."""
    cap = 80 * 10**9
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for shape in ("train_4k", "decode_32k"):
            rec = dryrun.run_cell(arch, shape, name, tmp_path, capacity=cap)
            assert rec["status"] == "ok", rec.get("error")
            saved = json.loads((tmp_path / name / f"{arch}__{shape}.json").read_text())
            assert saved == json.loads(json.dumps(rec))
            for key in ("memory_analysis", "cost_analysis", "collectives"):
                assert key not in rec
            assert rec["chips"] == (512 if name == "multi" else 256)
            assert rec["params_total"] == analytic.param_count(cfg)
            pc = rec["per_card"]
            assert pc["fits"] == (pc["total_bytes"] <= cap)
            assert ("optimizer_bytes" in pc) == (shape == "train_4k")
            assert rec["analytic"]["flops"] == analytic.step_flops(cfg, shape)
        jpolicy = jmesh.make_policy(jax_mesh(name), jcfg)
        assert pc["param_bytes"] == _jax_param_bytes(jcfg, jpolicy, jax_mesh(name))
    assert not (dryrun.ART_DIR.parent / "dryrun").exists()


def test_dryrun_records_a_failing_cell_and_exits_1(tmp_path, monkeypatch):
    def broken(arch):
        raise RuntimeError("no model")

    monkeypatch.setattr(dryrun, "meta_state", broken)
    rec = dryrun.run_cell("qwen3-1.7b", "train_4k", "single", tmp_path, capacity=1)
    assert rec["status"] == "error" and "no model" in rec["error"]
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k", "--mesh", "single",
                     "--art-dir", str(tmp_path)])


def test_dryrun_main_skips_full_attention_at_500k(tmp_path, capsys):
    dryrun.main(["--arch", "gemma-7b", "--mesh", "multi", "--art-dir", str(tmp_path),
                 "--capacity-bytes", str(80 * 10**9)])
    out = capsys.readouterr().out
    assert "done: 3 ok, 0 errors, 1 skipped" in out
    assert sorted(p.name for p in (tmp_path / "multi").iterdir()) == [
        f"gemma-7b__{s}.json" for s in ("decode_32k", "prefill_32k", "train_4k")]


# ---------------------------------------------------------------------------
# the trainer under a one-card policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _CountingPolicy(sharding.MeshPolicy):
    """A policy that records the entries of each constraint the model's
    layers ask it for."""

    calls: list = dataclasses.field(default_factory=list, compare=False)

    def constrain(self, x, *axes):
        self.calls.append(axes)
        return super().constrain(x, *axes)


def _counting(policy: sharding.MeshPolicy) -> _CountingPolicy:
    return _CountingPolicy(**{f.name: getattr(policy, f.name)
                              for f in dataclasses.fields(sharding.MeshPolicy)})


def _train(policy, steps=3):
    cfg = get_config("qwen3-1.7b").reduced(n_layers=2, d_model=32, d_ff=64)
    model = Model(cfg, device="cpu")
    tr = Trainer(model, AdamWConfig(lr_peak=1e-3, warmup_steps=1, decay_steps=steps),
                 TrainerConfig(steps=steps), policy=policy)
    state = tr.init_state(3)
    losses = []
    for step in range(steps):
        batch = pipeline.synthetic_batch_at(step, seed=5, batch_size=2, seq_len=16,
                                            vocab_size=cfg.vocab_size, device="cpu")
        state, metrics = tr.train_step(state, batch)
        losses.append(metrics["loss"].item())
    return cfg, losses, state


def test_trainer_with_a_one_card_policy_trains_bit_for_bit():
    """The trainer installs the policy and the layers read it: each step's
    forward and recomputed backward ask it for their constraints."""
    cfg, plain, plain_state = _train(None)
    policy = _counting(mesh.make_policy(mesh.make_host_mesh(1), cfg))
    _, got, state = _train(policy)
    assert got == plain
    assert policy.calls
    assert (policy.dp_spec, None, None) in policy.calls  # act_bsd
    assert (policy.dp_spec, None, policy.tp) in policy.calls  # act_bsf, act_logits
    for n, p in state["params"].items():
        assert torch.equal(p, plain_state["params"][n]), n
    with pytest.raises(NotImplementedError, match="multi-card path"):
        Trainer(Model(cfg, device="cpu"), AdamWConfig(), TrainerConfig(),
                policy=mesh.make_policy(port_mesh("single"), cfg))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama4-scout-17b-a16e", "mamba2-130m",
                                  "recurrentgemma-9b"])
def test_layers_read_the_active_policy(arch):
    """Every family's forward, prefill and decode step read the installed
    policy where the reference's layers constrain: a one-card policy is
    asked and changes nothing, and a 16x16 mesh's policy fails in the
    forward, naming the multi-card path."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator()
                           .manual_seed(4))

    def run():
        logits, _ = model.apply(tokens)
        last, caches = model.prefill(tokens, 24)
        step, _ = model.decode_step(tokens[:, :1], caches,
                                    torch.full((2,), 16, dtype=torch.int32))
        return logits, last, step

    with torch.no_grad():
        plain = run()
        one = _counting(mesh.make_policy(mesh.make_host_mesh(1), cfg))
        with sharding.use_policy(one):
            got = run()
        for x, y in zip(got, plain):
            assert torch.equal(x, y)
        # every layer's output and the embedding and logits, in each of 3 calls
        assert len(one.calls) >= 3 * (cfg.n_layers + 2)
        big = mesh.make_policy(port_mesh("single"), cfg)
        with sharding.use_policy(big), pytest.raises(NotImplementedError,
                                                      match="multi-card path"):
            model.apply(tokens)
