"""Threadle.CLIconsole analogue: the paper's scripting language (§3.4).

Interprets the command set of Listings 2–3 over a session namespace, in
two output modes — human-readable ``text`` and machine-readable ``json``
(the mode threadleR drives), with the JAX package's parser and output
format. A session names its device (``Session(device=...)``; ``None`` is
the CUDA card): the networks it creates, loads and recovers live there.
The serving commands (``serve``, ``servenet``, ``pingnet``,
``stopserve``) run the port's serving engine and wire frontend
(``repro_torch.serve``).
Example script (paper Listing 2, mini):

    nodes = createnodeset(createnodes = 20000)
    net = createnetwork(nodeset = nodes)
    addlayer(net, "Random", mode = 1, directed = false)
    generate(net, "Random", type = er, p = 0.0005)
    addlayer(net, "Workplaces", mode = 2)
    generate(net, "Workplaces", type = 2mode, h = 100, a = 5)
    checkedge(net, Workplaces, 100, 500)
    getnodealters(net, 100, layernames = Workplaces; Random)
    shortestpath(net, 100, 500)
    memoryreport(net)
    savefile(net, file = "bench.npz")

Commands mutate by rebinding (the engine is functional): ``addlayer(net,
...)`` rebinds ``net``. Run a script:
``python -m repro_torch.core.cli script.thr [--json] [--device cpu]`` or
pipe via stdin.
"""

from __future__ import annotations

import json
import re
import sys

import numpy as np
import torch

from . import api
from .csr import resolve_device
from .memory import memory_report
from .nodeset import NodeSelection
from .request import QueryRequest

class CLIError(ValueError):
    pass


def _split_outside_quotes(s: str, sep: str) -> list[str]:
    """Split on ``sep`` only where it is not inside a double-quoted string
    (the _TOKEN-regex tokenizer split `file = "my,file.npz"` into three
    tokens — quotes must win over separators)."""
    out, buf, in_q = [], [], False
    for ch in s:
        if ch == '"':
            in_q = not in_q
            buf.append(ch)
        elif ch == sep and not in_q:
            out.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    out.append("".join(buf))
    return out


def _find_outside_quotes(s: str, ch: str) -> int:
    """Index of the first ``ch`` outside double quotes, or -1."""
    in_q = False
    for i, c in enumerate(s):
        if c == '"':
            in_q = not in_q
        elif c == ch and not in_q:
            return i
    return -1


def _strip_comment(line: str) -> str:
    i = _find_outside_quotes(line, "#")
    return line if i < 0 else line[:i]


def _parse_value(tok: str):
    tok = tok.strip()
    if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
        return tok[1:-1]
    low = tok.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # bare identifier (variable name / enum like `er`)


def _parse_call(line: str):
    """'x = cmd(a, k = v, names = A; B)' -> (target, cmd, args, kwargs)."""
    target = None
    head = line.split("(", 1)[0]
    if "=" in head:
        target, line = (s.strip() for s in line.split("=", 1))
    m = re.match(r"^\s*(\w+)\s*\((.*)\)\s*$", line, re.S)
    if not m:
        raise CLIError(f"cannot parse: {line!r}")
    cmd, body = m.group(1), m.group(2)
    args, kwargs = [], {}
    for tok in _split_outside_quotes(body, ","):
        tok = tok.strip()
        if not tok:
            continue
        eq = -1 if tok.startswith('"') else _find_outside_quotes(tok, "=")
        if eq >= 0:
            k, v = tok[:eq].strip(), tok[eq + 1 :].strip()
            parts = _split_outside_quotes(v, ";")
            if len(parts) > 1:
                kwargs[k] = [_parse_value(x) for x in parts]
            else:
                kwargs[k] = _parse_value(v)
        else:
            parts = _split_outside_quotes(tok, ";")
            if len(parts) > 1:  # positional i; j; k lists (khop, walkbatch)
                args.append([_parse_value(x) for x in parts])
            else:
                args.append(_parse_value(tok))
    return target, cmd, args, kwargs


def _jsonable(x):
    """Engine results -> JSON-safe values (numpy scalars/arrays, selections)."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, NodeSelection):
        return {"count": x.count, "n_nodes": x.n_nodes}
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.bool_,)):
        return bool(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


class Session:
    """Names -> engine objects; dispatches the paper's command set.

    ``device``: where the session's networks live (``None``: the CUDA
    card, which must be present)."""

    def __init__(self, mode: str = "text", device=None):
        self.env: dict = {}
        self.mode = mode
        self.device = resolve_device(device)

    # -- helpers -------------------------------------------------------------

    def _resolve(self, v):
        if isinstance(v, str) and v in self.env:
            return self.env[v]
        return v

    def _emit(self, command: str, result) -> str:
        if self.mode == "json":
            return json.dumps({"command": command, "result": _jsonable(result)})
        return f"{result}"

    def _node_filter(self, filter):
        """Resolve a CLI ``filter=`` argument to a NodeSelection/mask."""
        if filter is None:
            return None
        if isinstance(filter, str):
            raise CLIError(f"unknown selection {filter!r} (not a variable)")
        return filter

    # -- command dispatch ----------------------------------------------------

    def run_line(self, line: str) -> str | None:
        line = _strip_comment(line).strip()
        if not line:
            return None
        target, cmd, args, kwargs = _parse_call(line)
        args = [self._resolve(a) for a in args]
        kwargs = {k: self._resolve(v) for k, v in kwargs.items()}
        handler = getattr(self, f"_cmd_{cmd}", None)
        if handler is None:
            raise CLIError(f"unknown command {cmd!r}")
        out, value = handler(*args, **kwargs)
        if target is not None:
            self.env[target] = value if value is not None else out
        return self._emit(cmd, out) if out is not None else None

    def run_script(self, text: str) -> list[str]:
        outputs = []
        for line in text.splitlines():
            res = self.run_line(line)
            if res is not None:
                outputs.append(res)
        return outputs

    # -- the paper's commands --------------------------------------------------

    def _cmd_createnodeset(self, *, createnodes: int):
        ns = api.createnodeset(createnodes, device=self.device)
        return None, ns

    def _cmd_createnetwork(self, *, nodeset):
        if isinstance(nodeset, int):
            return None, api.createnetwork(nodeset, device=self.device)
        return None, api.createnetwork(nodeset)

    def _cmd_addlayer(self, net, name, *, mode=1, directed=False, valued=False):
        new = api.addlayer(net, str(name), mode=mode, directed=directed,
                           valued=valued)
        self._rebind(net, new)
        return None, new

    def _cmd_generate(self, net, name, *, type, seed=0, **params):
        new = api.generate(net, str(name), type=str(type), seed=seed, **params)
        self._rebind(net, new)
        return None, new

    def _cmd_checkedge(self, net, layer, u, v, *, filter=None):
        return bool(api.checkedge(
            net, str(layer), int(u), int(v),
            filter=self._node_filter(filter),
        )), None

    def _cmd_getedge(self, net, layer, u, v, *, filter=None):
        # serve-kind commands build the same typed QueryRequest the api,
        # serve engine, and wire frontend dispatch
        req = QueryRequest.getedge(
            str(layer), int(u), int(v), filter=self._node_filter(filter)
        )
        return float(api.runquery(net, req)), None

    def _cmd_getnodealters(self, net, u, *, layernames=None, max_alters=4096,
                           filter=None):
        req = QueryRequest.alters(
            int(u), layers=_names(layernames), max_alters=int(max_alters),
            filter=self._node_filter(filter),
        )
        return np.asarray(api.runquery(net, req)).tolist(), None

    def _cmd_shortestpath(self, net, u, v, *, layernames=None):
        return api.shortestpath(
            net, int(u), int(v), layernames=_names(layernames)
        ), None

    def _cmd_memoryreport(self, net):
        rep = memory_report(net)
        if self.mode == "json":
            return {
                "total_bytes": rep.total_nbytes,
                "resident_rss_bytes": rep.resident_rss_bytes,
                "peak_rss_bytes": rep.peak_rss_bytes,
                "layers": [
                    {
                        "name": l.name, "mode": l.mode, "bytes": l.nbytes,
                        "edges": l.n_edges,
                        "equivalent_projected_edges":
                            l.equivalent_projected_edges,
                        "compression_ratio": l.compression_ratio,
                    }
                    for l in rep.layers
                ],
            }, None
        return rep.pretty(), None

    def _cmd_savefile(self, obj, *, file, compress=True):
        api.savefile(obj, str(file), compress=bool(compress))
        return f"saved {file}", None

    def _cmd_loadfile(self, *, file, mmap=False):
        return None, api.loadfile(str(file), mmap=bool(mmap),
                                  device=self.device)

    # -- attribute manager + selections (paper §3.1 / §3.4) -------------------

    def _cmd_setattr(self, net, name, nodes, values, *, kind=None):
        new = api.setnodeattr(
            net, str(name), nodes, values,
            kind=None if kind is None else str(kind),
        )
        self._rebind(net, new)
        return None, new

    def _cmd_getattr(self, net, name, nodes):
        vals, has = api.getnodeattr(net, str(name), nodes)
        kind = net.nodeset.attrs.column(str(name)).kind
        out = [
            (chr(int(v)) if kind == "char" else _jsonable(v)) if h else None
            for v, h in zip(np.atleast_1d(vals), np.atleast_1d(has))
        ]
        return (out[0] if np.ndim(nodes) == 0 else out), None

    def _cmd_dropattr(self, net, name):
        new = api.dropattr(net, str(name))
        self._rebind(net, new)
        return None, new

    def _cmd_listattrs(self, net):
        return api.listattrs(net), None

    def _cmd_loadattrs(self, net, *, file, name=None, kind=None):
        new = api.loadattrs(
            net, str(file),
            name=None if name is None else str(name),
            kind=None if kind is None else str(kind),
        )
        self._rebind(net, new)
        loaded = [a for a in new.nodeset.attrs.names
                  if a not in net.nodeset.attrs.names]
        return {"loaded": loaded or list(new.nodeset.attrs.names)}, new

    def _cmd_selectnodes(self, net, *, attr, op, value=None):
        sel = api.selectnodes(net, str(attr), str(op), value)
        return {"count": sel.count}, sel

    def _cmd_combineselect(self, a, b, *, op="and"):
        if not isinstance(a, NodeSelection) or not isinstance(b, NodeSelection):
            raise CLIError("combineselect needs two selection variables")
        if str(op) == "and":
            sel = a & b
        elif str(op) == "or":
            sel = a | b
        else:
            raise CLIError(f"combineselect op must be and/or, got {op!r}")
        return {"count": sel.count}, sel

    def _cmd_invertselect(self, sel):
        if not isinstance(sel, NodeSelection):
            raise CLIError("invertselect needs a selection variable")
        inv = ~sel
        return {"count": inv.count}, inv

    def _cmd_countnodes(self, net, sel=None):
        return api.countnodes(net, sel), None

    def _cmd_attributesummary(self, net, name):
        return api.attributesummary(net, str(name)), None

    # -- degree / structure ---------------------------------------------------

    def _cmd_getdegree(self, net, u, *, layernames=None, filter=None):
        req = QueryRequest.degree(
            int(u), layers=_names(layernames),
            filter=self._node_filter(filter),
        )
        return _jsonable(api.runquery(net, req)), None

    def _cmd_degreedist(self, net, *, layernames=None, filter=None):
        dist = api.degreedist(
            net, layernames=_names(layernames),
            filter=self._node_filter(filter),
        )
        if self.mode == "json":
            return dist, None
        return " ".join(f"{d}:{c}" for d, c in dist), None

    def _cmd_density(self, net, layer):
        return float(api.getdensity(net, str(layer))), None

    def _cmd_components(self, net, *, layernames=None):
        return api.countcomponents(net, layernames=_names(layernames)), None

    # -- batched traversal (paper §5 / threadleR workloads) -------------------

    def _cmd_khop(self, net, nodes, *, k, layernames=None, maxfrontier=None,
                  filter=None):
        req = QueryRequest.khop(
            [int(i) for i in _ids(nodes)], int(k),
            layers=_names(layernames),
            max_frontier=None if maxfrontier is None else int(maxfrontier),
            filter=self._node_filter(filter),
        )
        return api.runquery(net, req), None

    def _cmd_egosample(self, net, egos, *, max_alters=4096, k=1,
                       layernames=None, filter=None):
        return api.egosample(
            net, _ids(egos), max_alters=int(max_alters), k=int(k),
            layernames=_names(layernames),
            filter=self._node_filter(filter),
        ), None

    def _cmd_walkbatch(self, net, starts, *, steps, walkers=1, seed=0,
                       layernames=None, layerweights=None, filter=None):
        weights = None
        if layerweights is not None:
            weights = [
                float(w) for w in (
                    layerweights if isinstance(layerweights, list)
                    else [layerweights]
                )
            ]
        req = QueryRequest.walkbatch(
            [int(i) for i in _ids(starts)], int(steps),
            walkers=int(walkers), seed=int(seed),
            layers=_names(layernames), layer_weights=weights,
            filter=self._node_filter(filter),
        )
        return np.asarray(api.runquery(net, req)).tolist(), None

    def _cmd_componentsfast(self, net, *, layernames=None, filter=None):
        return api.componentsfast(
            net, layernames=_names(layernames),
            filter=self._node_filter(filter),
        ), None

    # -- serving (paper §3.1 threadleR deployment) ----------------------------

    def _cmd_serve(self, net, *, file, cache=4096, queuelimit=8192,
                   maxheavy=1024):
        """Replay a JSONL request-trace file through the serve engine."""
        import time

        t0 = time.perf_counter()
        records, stats = api.serve(
            net, str(file), cache_size=int(cache),
            queue_limit=int(queuelimit), max_heavy_per_round=int(maxheavy),
        )
        dt = time.perf_counter() - t0
        qps = len(records) / dt if dt > 0 else float("inf")
        if self.mode == "json":
            return {
                "served": len(records),
                "seconds": dt,
                "qps": qps,
                "stats": stats,
                "results": records,
            }, None
        c = stats["cache"]
        shared = c["hits"] + stats["coalesced_dupes"]
        return (
            f"served {len(records)} requests in {dt:.3f}s ({qps:,.0f} qps); "
            f"{shared}/{len(records)} shared ({c['hits']} cache hits, "
            f"{stats['coalesced_dupes']} coalesced), "
            f"evictions {c['evictions']}; batches "
            + " ".join(
                f"{k}={v}" for k, v in stats["batches"].items() if v
            )
        ), None

    def _cmd_servenet(self, net, *, host="127.0.0.1", port=0, cache=4096,
                      queuelimit=8192, maxheavy=1024, deadline=None):
        """Start the NDJSON/TCP serve frontend; bind the handle with
        ``srv = servenet(net, ...)`` and stop it with ``stopserve(srv)``.
        ``deadline`` is the default per-request budget in ms."""
        fe = api.servenet(
            net, host=str(host), port=int(port), cache_size=int(cache),
            queue_limit=int(queuelimit), max_heavy_per_round=int(maxheavy),
            deadline_ms=None if deadline is None else float(deadline),
        )
        h, p = fe.address
        return {"host": h, "port": p, "serving": True}, fe

    def _cmd_pingnet(self, *, host="127.0.0.1", port, deadline=2000):
        """Probe a running serve frontend (latency + readiness)."""
        return api.pingnet(str(host), int(port),
                           deadline_ms=float(deadline)), None

    def _cmd_stopserve(self, frontend):
        """Close a frontend started by ``servenet`` (drains + joins)."""
        if not hasattr(frontend, "close") or not hasattr(frontend, "stats"):
            raise CLIError("stopserve needs a servenet() handle")
        stats = frontend.stats
        frontend.close()
        return {
            "stopped": True,
            "served": stats["engine"]["served"],
            "requests": stats["transport"].get("requests", 0),
        }, None

    # -- container surface ----------------------------------------------------

    def _cmd_addedges(self, net, layer, src, dst, *, values=None):
        new = api.addedges(net, str(layer), _ids(src), _ids(dst),
                           values=values)
        self._rebind(net, new)
        return None, new

    def _cmd_deleteedges(self, net, layer, src, dst):
        new = api.deleteedges(net, str(layer), _ids(src), _ids(dst))
        self._rebind(net, new)
        return None, new

    # -- durable store (WAL + snapshots, core/snapshot.py) --------------------

    def _cmd_savestore(self, net, *, dir):
        return api.savestore(net, str(dir)), None

    def _cmd_recovernet(self, *, dir):
        net, info = api.recovernet(str(dir), device=self.device)
        return info, net

    def _cmd_wallog(self, *, dir, after=-1):
        return api.wallog(str(dir), after=int(after)), None

    def _cmd_listlayers(self, net):
        return api.listlayers(net), None

    def _cmd_deletelayer(self, net, name):
        new = api.deletelayer(net, str(name))
        self._rebind(net, new)
        return None, new

    def _cmd_describenet(self, net):
        return api.describenet(net), None

    def _cmd_exportlayer(self, net, layer, *, file):
        api.exportlayer(net, str(layer), str(file))
        return f"exported {layer} to {file}", None

    def _cmd_importlayer(self, net, name, *, file, mode=1, directed=False,
                         valued=False, n_hyperedges=None, default_value=None,
                         chunk_rows=None, narrow=True):
        new = api.importlayer(
            net, str(name), str(file), mode=int(mode),
            directed=bool(directed), valued=bool(valued),
            n_hyperedges=None if n_hyperedges is None else int(n_hyperedges),
            default_value=default_value,
            chunk_rows=None if chunk_rows is None else int(chunk_rows),
            narrow=bool(narrow),
        )
        self._rebind(net, new)
        return None, new

    def _cmd_subnetwork(self, net, sel):
        if not isinstance(sel, NodeSelection):
            raise CLIError("subnetwork needs a selection variable")
        sub = api.subnetwork(net, sel)
        return {"n_nodes": sub.n_nodes,
                "layers": list(sub.layer_names)}, sub

    def _cmd_samplenodes(self, net, n, *, seed=0, filter=None):
        sel = self._node_filter(filter)
        if sel is not None and not isinstance(sel, NodeSelection):
            sel = NodeSelection(np.asarray(sel, dtype=bool))
        ids = api.samplenodes(net, int(n), seed=int(seed), selection=sel)
        return ids.tolist(), None

    # rebinding: commands that 'mutate' a network rebind every name that
    # pointed at the old object (functional engine, paper-style syntax)
    def _rebind(self, old, new):
        for k, v in list(self.env.items()):
            if v is old:
                self.env[k] = new

    @classmethod
    def commands(cls) -> list[str]:
        """Every dispatchable command name (the paper's command surface)."""
        return sorted(
            m[len("_cmd_"):] for m in dir(cls) if m.startswith("_cmd_")
        )


def _ids(nodes) -> list[int]:
    """Normalize a CLI node-id value (bare id or i; j; k list) to ints."""
    return [int(n) for n in (nodes if isinstance(nodes, list) else [nodes])]


def _names(layernames) -> list[str] | None:
    """Normalize a CLI layernames value (bare name or A; B list) to a list."""
    if layernames is None:
        return None
    return [str(n) for n in (
        layernames if isinstance(layernames, list) else [layernames]
    )]


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("script", nargs="?", help="script file (default: stdin)")
    ap.add_argument("--json", action="store_true", help="JSON output mode")
    ap.add_argument("--device", default=None,
                    help="device of the session's networks (default: the "
                    "CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args()
    text = (
        open(args.script).read() if args.script else sys.stdin.read()
    )
    session = Session(mode="json" if args.json else "text", device=args.device)
    for out in session.run_script(text):
        print(out)


if __name__ == "__main__":
    main()
