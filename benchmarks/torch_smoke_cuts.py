"""What each of ``chip_smoke.py``'s cuts for time saves, on one host.

The smoke must finish within its 1,200 s on every host it may get, and
hosts differ up to twice in host-bound work. Four constants shrink work
that the smoke's other phases do not need at full size. This script runs
each piece of work that one of them shrinks at the smoke's size and at
the size before the cut, in one process on one card, so that the two
times come from the same host:

- ``PANEL_NODES`` (the nodes given Panel memberships): the Panel layer's
  build and its pairs, at n/2 and n of the smoke's 10M nodes;
- ``STORE_NODES``: the store network's build, mutation and compaction,
  the durable store and the CLI's store commands, at 500,000 and 1M nodes;
- ``LM_FAMILY_LAYERS`` of internvl2-26b and musicgen-large: each served
  and checked as the lm_families phase does, at 8 and 16 of 48 layers.

``SERVE_LOOP_STRIDE`` is not run here: its loop needs the smoke's 10M
network and engine, and the smoke prints the loop's requests and seconds
(every 16th request runs half as many as every 8th, at the same rate).

    PYTHONPATH=src python benchmarks/torch_smoke_cuts.py

Prints one line a size, then one JSON object: each cut's seconds at both
sizes and what the cut saves. Needs one card.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

CUT_FAMILIES = ("internvl2-26b", "musicgen-large")


def timed(label: str, fn) -> float:
    import torch

    t0 = time.perf_counter()
    fn()
    cs.sync()
    seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    cs.log(f"cuts: {label}: {seconds:.3f} s; {cs.device_line()}")
    return seconds


def panel(members: int, device) -> None:
    cs.PANEL_NODES = members
    layer = cs.build_panel(cs.N_NODES, cs.SEED, device)
    cs.panel_pairs(layer, members, cs.SEED, device)


def store(n_nodes: int, device) -> None:
    """The storage phase's store part at ``n_nodes``, as its cut branch
    runs it."""
    from repro_torch.core import api

    with tempfile.TemporaryDirectory(prefix="threadle-cuts-") as tmpname:
        tmp = Path(tmpname)
        card = cs.device_line()
        base, _ = cs.build_network(n_nodes, cs.SEED, device)
        ops, _ = cs.register_ops(base, cs.SEED, device)
        small, _, _ = cs.mutate(base, ops, "cuts: store mutation", profile=False)
        compact = small.compacted()
        path = tmp / "store_net.npz"
        api.savefile(base, str(path), compress=False)
        cs.storage_store(base, compact, ops, tmp, card, device)
        cs.storage_cli_store(path, tmp, card, device)


def families(depth: int, device) -> None:
    cs.LM_FAMILY_LAYERS = {**cs.LM_FAMILY_LAYERS, **dict.fromkeys(CUT_FAMILIES, depth)}
    configs = cs.family_configs()
    for arch in CUT_FAMILIES:
        cs.lm_serve(arch, configs[arch], device, cs.SEED, phase="lm_families",
                    repeats=cs.LM_FAMILY_REPEATS, prefills=cs.LM_FAMILY_PREFILLS,
                    phase_kinds=("greedy",))
        cs.lm_decode_check(arch, configs[arch], device, cs.SEED, phase="lm_families",
                           n_layers=cs.LM_FAMILY_CHECK_DEFAULT_LAYERS)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_smoke_cuts: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    device = torch.device("cuda")
    cs.log(cs.device_line())
    build.build()
    cut_panel, cut_store = cs.PANEL_NODES, cs.STORE_NODES
    cut_depth = {cs.LM_FAMILY_LAYERS[a] for a in CUT_FAMILIES}.pop()
    sizes = {
        "PANEL_NODES": (panel, cut_panel, cs.N_NODES),
        "STORE_NODES": (store, cut_store, 1_000_000),
        "LM_FAMILY_LAYERS": (families, cut_depth, 16),
    }
    result = {}
    for name, (fn, smoke_size, uncut) in sizes.items():
        secs = {size: timed(f"{name} = {size}", lambda: fn(size, device))
                for size in (smoke_size, uncut)}
        result[name] = {"smoke": smoke_size, "smoke_s": secs[smoke_size],
                        "uncut": uncut, "uncut_s": secs[uncut],
                        "saves_s": secs[uncut] - secs[smoke_size]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
