"""Post-SPMD HLO analysis with while-loop trip-count amplification.

``src/repro/perf/hlo_analysis.py`` as it is: a parser of XLA's HLO text,
which imports nothing of JAX. The port compiles no HLO of its own; this
reads the text the JAX package's dry run saves (``--save-hlo``), so that
both packages give the same collective bytes for the same program.

A naive text scan counts while-loop bodies ONCE, and the JAX package's
programs are scans of scans (accum × layer groups × attention chunks), so
per-step collective bytes must be multiplied by every enclosing loop's
trip count. This module splits the text into computations, builds the
call graph (while bodies, fusions, calls), takes each loop's trip count
from the largest integer constant of its condition computation, and
propagates execution multiplicity from ENTRY, yielding per-device
collective wire bytes.
"""

from __future__ import annotations

import re
from collections import defaultdict

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4,
    "u16": 2, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

# ring-algorithm wire-cost multipliers applied to each op's result bytes
WIRE_FACTOR = {
    "all-reduce": 2.0,       # reduce-scatter + all-gather phases
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# header: `%name (params...) -> type {` — params may nest parens (tuple
# types), so only anchor on the name and the trailing `-> ... {`
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*\(")
_SHAPE = re.compile(r"(\w+?)\[([0-9,]*)\]")
_COLL = re.compile(
    r"=\s*((?:\([^)]*\))|(?:\S+))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)
_CALLSITE = re.compile(r"(?:body|calls|to_apply)=%?([\w\.\-]+)")
_COND = re.compile(r"condition=%?([\w\.\-]+)")
_CONST_INT = re.compile(r"constant\((\d+)\)")


def _type_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _split_computations(hlo: str) -> dict[str, str]:
    """computation name -> body text."""
    comps: dict[str, str] = {}
    name = None
    buf: list[str] = []
    for line in hlo.splitlines():
        s = line.strip()
        is_hdr = (
            s.endswith("{")
            and "->" in s
            and not line.startswith(("  ", "\t"))  # instructions are indented
            and "=" not in s.split("(")[0]
        )
        m = _COMP_HDR.match(s) if is_hdr else None
        if m:
            if name is not None:
                comps[name] = "\n".join(buf)
            name = m.group(1)
            buf = [line]
        else:
            buf.append(line)
    if name is not None:
        comps[name] = "\n".join(buf)
    return comps


def _entry_name(hlo: str) -> str | None:
    m = re.search(r"^ENTRY %?([\w\.\-]+)", hlo, re.M)
    return m.group(1) if m else None


def analyze_collectives(hlo: str) -> dict:
    """Exact per-device collective wire bytes with loop amplification."""
    comps = _split_computations(hlo)
    entry = _entry_name(hlo)
    if entry is None or entry not in comps:  # fall back: flat scan
        entry = next(iter(comps), None)

    # per-computation: raw collective bytes + call edges (callee, trip)
    raw: dict[str, dict] = {}
    edges: dict[str, list[tuple[str, float]]] = defaultdict(list)
    for cname, body in comps.items():
        by_type: dict = defaultdict(
            lambda: {"count": 0, "result_bytes": 0, "f32_bytes": 0}
        )
        for m in _COLL.finditer(body):
            b = _type_bytes(m.group(1))
            by_type[m.group(2)]["count"] += 1
            by_type[m.group(2)]["result_bytes"] += b
            # XLA:CPU upcasts bf16 dot partial sums to f32 before the TP
            # all-reduce; the TPU target reduces in bf16. Track the f32
            # share so the roofline can report a TPU-adjusted term.
            by_type[m.group(2)]["f32_bytes"] += _type_bytes(
                "".join(
                    f"{dt}[{dims}]"
                    for dt, dims in _SHAPE.findall(m.group(1))
                    if dt == "f32"
                )
            )
        raw[cname] = dict(by_type)
        for line in body.splitlines():
            if " while(" in line:
                mbody = _CALLSITE.search(line)
                mcond = _COND.search(line)
                trip = 1.0
                if mcond and mcond.group(1) in comps:
                    ints = [
                        int(x) for x in _CONST_INT.findall(comps[mcond.group(1)])
                    ]
                    if ints:
                        trip = float(max(ints))
                if mbody:
                    edges[cname].append((mbody.group(1), trip))
            else:
                for mc in _CALLSITE.finditer(line):
                    edges[cname].append((mc.group(1), 1.0))

    # propagate multiplicity from entry (call graph is a DAG in HLO)
    mult: dict[str, float] = defaultdict(float)
    mult[entry] = 1.0
    order = [entry]
    seen = {entry}
    # BFS topological-ish; HLO computations cannot recurse
    i = 0
    while i < len(order):
        c = order[i]
        i += 1
        for callee, trip in edges.get(c, ()):
            if callee not in raw:
                continue
            mult[callee] += mult[c] * trip
            if callee not in seen:
                seen.add(callee)
                order.append(callee)

    total_by_type: dict = defaultdict(
        lambda: {"count": 0.0, "result_bytes": 0.0, "f32_bytes": 0.0}
    )
    for cname, by_type in raw.items():
        m = mult.get(cname, 0.0)
        if m == 0.0:
            continue
        for op, v in by_type.items():
            total_by_type[op]["count"] += v["count"] * m
            total_by_type[op]["result_bytes"] += v["result_bytes"] * m
            total_by_type[op]["f32_bytes"] += v["f32_bytes"] * m

    wire = sum(
        v["result_bytes"] * WIRE_FACTOR[k] for k, v in total_by_type.items()
    )
    # TPU-adjusted: f32 reduction collectives would move bf16 on the target
    wire_tpu = sum(
        (v["result_bytes"] - 0.5 * v["f32_bytes"]) * WIRE_FACTOR[k]
        for k, v in total_by_type.items()
    )
    return {
        "by_type": {k: dict(v) for k, v in total_by_type.items()},
        "wire_bytes_per_device": wire,
        "wire_bytes_per_device_tpu_adjusted": wire_tpu,
        "n_computations": len(comps),
    }
