"""CLI parity of the PyTorch port (``repro_torch.core.cli``) with the JAX
package's (``repro.core.cli``) on the CPU.

The paper's Listing 2/3 scripts, the attribute, traversal, file, mutation
and store scripts, and the repository's verification script run through
both packages' ``Session`` in JSON mode and print equal lines. The one
expected difference is the port's valued ``addlayer`` (a departure on
purpose): there ``addedges(..., values = ...)`` works where the JAX
package raises. The tokenizer is the JAX package's, case for case. The
serving commands replay a trace file to the JAX package's output (its
timings aside), start, probe and stop a frontend, and treat a trace's
partial last line as the JAX package does.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import cli as jcli
from repro_torch.core import cli as tcli

REPO = Path(__file__).resolve().parents[1]

LISTING2 = """
# paper Listing 2, mini
nodes = createnodeset(createnodes = 500)
net = createnetwork(nodeset = nodes)
addlayer(net, "Random", mode = 1, directed = false)
generate(net, "Random", type = er, p = 0.02, seed = 1)
addlayer(net, "Workplaces", mode = 2)
generate(net, "Workplaces", type = 2mode, h = 10, a = 4, seed = 2)
"""

SCRIPTS = {
    "verify": """
nodes = createnodeset(createnodes = 5000)
net = createnetwork(nodeset = nodes)
addlayer(net, "W", mode = 2)
generate(net, "W", type = 2mode, h = 40, a = 6)
checkedge(net, W, 100, 500)
getedge(net, W, 100, 500)
getnodealters(net, 100, layernames = W)
memoryreport(net)
""",
    "listing3": LISTING2 + """
checkedge(net, Workplaces, 10, 20)
getedge(net, Workplaces, 10, 20)
getnodealters(net, 10, layernames = Workplaces; Random)
shortestpath(net, 0, 100)
getdegree(net, 10)
density(net, Random)
components(net)
""",
    "attributes": LISTING2 + """
setattr(net, income, nodes = 0;1;2;3;4;5;6;7, values = 10.0;90000.0;55000.0;70000.0;100.0;80000.0;60000.0;75000.0)
setattr(net, employed, 3, true)
setattr(net, grade, nodes = 1;2, values = A;B, kind = char)
rich = selectnodes(net, attr = income, op = gt, value = 50000)
emp = selectnodes(net, attr = employed, op = eq, value = true)
both = combineselect(rich, emp, op = and)
notrich = invertselect(rich)
countnodes(net, rich)
getattr(net, income, 1)
getattr(net, grade, nodes = 1;2;3)
getdegree(net, 1, filter = rich)
getnodealters(net, 1, layernames = Workplaces; Random, filter = rich)
listattrs(net)
attributesummary(net, income)
listlayers(net)
describenet(net)
degreedist(net, layernames = Random)
sub = subnetwork(net, rich)
describenet(sub)
samplenodes(net, 3, seed = 1, filter = rich)
dropattr(net, employed)
listattrs(net)
""",
    "traversal": LISTING2 + """
khop(net, 0; 7, k = 2, layernames = Random)
egosample(net, 0; 7, k = 2, layernames = Random)
walkbatch(net, 0; 7, steps = 5, walkers = 3, seed = 1)
componentsfast(net)
componentsfast(net, layernames = Workplaces)
""",
    "files": LISTING2 + """
savefile(net, file = "{tmp}/n.npz", compress = false)
net2 = loadfile(file = "{tmp}/n.npz", mmap = true)
getnodealters(net2, 10, layernames = Workplaces; Random)
exportlayer(net, Random, file = "{tmp}/r.tsv.gz")
deletelayer(net, Random)
importlayer(net, Random, file = "{tmp}/r.tsv.gz", chunk_rows = 7)
listlayers(net)
loadattrs(net, file = "{tmp}/a.tsv")
getattr(net, age, nodes = 0;1;2)
getdegree(net, 3)
""",
    "mutation and store": LISTING2 + """
getdegree(net, 1)
addedges(net, Random, src = 1;1, dst = 490;491)
getdegree(net, 1)
deleteedges(net, Random, src = 1, dst = 490)
addedges(net, Workplaces, src = 1;2, dst = 3;70000)
checkedge(net, Workplaces, 1, 2)
getnodealters(net, 1)
khop(net, 1; 2, k = 2)
savestore(net, dir = "{tmp}/state")
rec = recovernet(dir = "{tmp}/state")
wallog(dir = "{tmp}/state")
getdegree(rec, 1)
getnodealters(rec, 1)
""",
}


def _run(cli, script: str, tmp: Path, **kw) -> list:
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "a.tsv").write_text("node\tage:int\n0\t31\n2\t47\n")
    outs = cli.Session(mode="json", **kw).run_script(script.replace("{tmp}", str(tmp)))
    recs = [json.loads(o.replace(str(tmp), "<tmp>")) for o in outs]
    for rec in recs:
        if rec["command"] == "memoryreport":  # process-wide, not the network's
            rec["result"].pop("resident_rss_bytes")
            rec["result"].pop("peak_rss_bytes")
    return recs


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_scripts_print_equal_json(tmp_path, name):
    got = _run(tcli, SCRIPTS[name], tmp_path / "port", device="cpu")
    want = _run(jcli, SCRIPTS[name], tmp_path / "jax")
    assert [r["command"] for r in got] == [r["command"] for r in want]
    for g, w in zip(got, want):
        assert g == w, g["command"]


def test_valued_addlayer_is_the_one_difference():
    script = LISTING2 + """
addlayer(net, "Kin", mode = 1, valued = true)
addedges(net, Kin, src = 1;2, dst = 3;4, values = 2.5)
getedge(net, Kin, 1, 3)
"""
    out = tcli.Session(mode="json", device="cpu").run_script(script)
    assert json.loads(out[-1]) == {"command": "getedge", "result": 2.5}
    with pytest.raises(ValueError, match="unvalued"):
        jcli.Session(mode="json").run_script(script)


TOKENIZER_LINES = [
    'savefile(net, file = "my,file.npz")',
    'f(x, names = "A;B"; C, s = "x;y")',
    'f(x, s = "a = b")',
    "nodes = createnodeset(createnodes = 20000)",
    "getnodealters(net, 100, layernames = Workplaces; Random)",
    "khop(net, 0; 7, k = 2, maxfrontier = 64)",
    'setattr(net, income, nodes = 0;1, values = 1.5;-2e3, kind = "float")',
    "x = checkedge(net, W, 1, 2)",
    'f(flag = TRUE, other = False, word = er, q = "quoted")',
]


@pytest.mark.parametrize("line", TOKENIZER_LINES)
def test_tokenizer_equals_jax(line):
    assert tcli._parse_call(line) == jcli._parse_call(line)
    commented = line + ' # note "x"'
    assert tcli._strip_comment(commented) == jcli._strip_comment(commented)


SERVE_TRACE = [
    {"kind": "getedge", "layer": "Workplaces", "u": 10, "v": 20},
    {"kind": "degree", "u": [1, 2, 3]},
    {"kind": "getedge", "layer": "Workplaces", "u": 10, "v": 20},
    {"kind": "alters", "u": 10, "layers": ["Random"], "max_alters": 64},
    {"kind": "khop", "sources": 7, "k": 2, "max_frontier": 64,
     "layers": ["Random"]},
    {"kind": "walkbatch", "starts": [0, 7], "steps": 4, "walkers": 2,
     "seed": 1},
    {"kind": "teleport", "u": 1},
]


def _write_trace(path: Path, reqs, tail: str = "") -> Path:
    path.write_text("# trace\n" + "".join(json.dumps(r) + "\n" for r in reqs)
                    + tail)
    return path


@pytest.mark.parametrize("mode", ["json", "text"])
def test_serve_trace_equals_jax(tmp_path, mode):
    """``serve`` on a trace file prints the JAX package's output, its
    ``seconds`` and ``qps`` aside."""
    trace = _write_trace(tmp_path / "t.jsonl", SERVE_TRACE)
    script = LISTING2 + f'serve(net, file = "{trace}")\n'
    got = tcli.Session(mode=mode, device="cpu").run_script(script)
    want = jcli.Session(mode=mode).run_script(script)
    assert len(got) == len(want) == 1
    if mode == "json":
        got, want = json.loads(got[0]), json.loads(want[0])
        for rec in (got, want):
            assert rec["result"].pop("seconds") >= 0
            assert rec["result"].pop("qps") > 0
        assert got == want
        assert got["result"]["results"][2]["cached"] is True
        assert "teleport" in got["result"]["results"][-1]["error"]
    else:
        timing = re.compile(r"in [0-9.]+s \([0-9,.]+ qps\)")
        assert timing.sub("", got[0]) == timing.sub("", want[0])
        assert got[0].startswith(f"served {len(SERVE_TRACE)} requests")


def test_servenet_pingnet_stopserve_round_trip():
    s = tcli.Session(mode="json", device="cpu")
    s.run_script(LISTING2)
    started = json.loads(s.run_line("srv = servenet(net, port = 0)"))["result"]
    assert started["serving"] is True and started["port"] > 0
    probe = json.loads(s.run_line(
        f'pingnet(host = "127.0.0.1", port = {started["port"]})'))["result"]
    assert probe["ok"] is True and probe["ready"] is True
    stopped = json.loads(s.run_line("stopserve(srv)"))["result"]
    assert stopped == {"stopped": True, "served": 0, "requests": 2}
    assert s.env["srv"].engine.closed
    down = json.loads(s.run_line(
        f'pingnet(host = "127.0.0.1", port = {started["port"]})'))["result"]
    assert down["ok"] is False and down["reasons"]
    with pytest.raises(tcli.CLIError, match="servenet"):
        s.run_line("stopserve(net)")


@pytest.mark.parametrize("tail", ["complete", "torn"])
def test_serve_trace_with_a_partial_last_line(tmp_path, tail):
    """A last line without its newline is served when it is complete JSON
    and raises ``TruncatedFileError`` when it was torn mid-write, in both
    packages."""
    from repro.core.io import TruncatedFileError as JaxTruncated
    from repro_torch.core.io import TruncatedFileError

    last = ('{"kind": "degree", "u": 2}' if tail == "complete"
            else '{"kind": "deg')
    trace = _write_trace(tmp_path / "t.jsonl", SERVE_TRACE[:2], tail=last)
    script = LISTING2 + f'serve(net, file = "{trace}")\n'
    if tail == "torn":
        with pytest.raises(TruncatedFileError, match="torn mid-write"):
            tcli.Session(mode="json", device="cpu").run_script(script)
        with pytest.raises(JaxTruncated, match="torn mid-write"):
            jcli.Session(mode="json").run_script(script)
        return
    got = json.loads(tcli.Session(mode="json", device="cpu").run_script(script)[0])
    want = json.loads(jcli.Session(mode="json").run_script(script)[0])
    assert got["result"]["results"] == want["result"]["results"]
    assert [r["id"] for r in got["result"]["results"]] == [0, 1, 2]
    assert got["result"]["results"][-1]["result"] == want["result"]["results"][-1]["result"]


def test_command_surface_equals_jax():
    assert tcli.Session.commands() == jcli.Session.commands()


def test_unknown_command_raises():
    with pytest.raises(tcli.CLIError):
        tcli.Session(device="cpu").run_line("frobnicate(x)")


def test_module_entry_point_runs_a_script_on_the_named_device(tmp_path):
    script = tmp_path / "s.thr"
    script.write_text(LISTING2 + "getnodealters(net, 10, layernames = Workplaces)\n")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.cli", str(script), "--json",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = tcli.Session(mode="json", device="cpu").run_script(script.read_text())
    assert proc.stdout.splitlines() == want
