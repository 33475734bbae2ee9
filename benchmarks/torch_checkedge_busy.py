#!/usr/bin/env python3
"""Wall and device busy time of ``api.checkedge`` on ``chip_smoke.py``'s
two-mode layers, through the ``repro_torch`` package of a given tree, on
the ids the smoke draws.

    python3 benchmarks/torch_checkedge_busy.py [--src DIR] [--nodes N]

Builds the Households / Workplaces / Schools layers and the Panel layer
with the smoke's own recipe functions and seeds (``--nodes``, default the
smoke's ``N_NODES``), draws the smoke's pairs (the main path's x8192 on
each layer, the Panel's x8192 and its x1,048,576 dyad sample) and prints,
for each checkedge call, its median wall time and the device busy time of
one profiled call (every device activity summed), with the busiest. The
``repro_torch`` package is imported from ``--src`` (default: this tree's
``src``): given the ``src`` of another commit (a ``git archive`` of it),
the script measures that commit's route on the same layers and ids. Needs
a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(ROOT / "src"),
                        help="directory holding the repro_torch package to measure")
    parser.add_argument("--nodes", type=int, default=None,
                        help="nodes of the network (default: the smoke's N_NODES)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_checkedge_busy: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import api
    from repro_torch.core.layers import two_mode_from_membership_chunks

    device = torch.device("cuda")
    n = args.nodes or cs.N_NODES
    cs.log(f"{cs.device_line()}; repro_torch from {api.__file__}; {n} nodes")
    t0 = time.perf_counter()
    net = api.createnetwork(api.createnodeset(n, device=device))
    for i, (name, per_node, npg) in enumerate(cs.LAYER_RECIPE):
        n_groups = max(int(n / npg), 1)
        net = net.with_layer(name, two_mode_from_membership_chunks(
            n, n_groups, cs.membership_chunks(n, per_node, n_groups, cs.SEED + 100 + i),
            device=device))
    panel = cs.build_panel(n, cs.SEED, device)
    net = net.with_layer("Panel", panel)
    cs.log(f"layers built in {time.perf_counter() - t0:.3f} s")

    calls = {f"{name} x{cs.POINT_PAIRS}": (name, u, v) for name, (u, v) in
             cs.edge_pairs(net, np.random.default_rng(cs.SEED + 2), device).items()}
    (u, v), (du, dv) = cs.panel_pairs(panel, min(cs.PANEL_NODES, n), cs.SEED, device)
    calls[f"Panel x{cs.POINT_PAIRS}"] = ("Panel", u, v)
    calls[f"Panel x{cs.DYAD_PAIRS} (dyad sample)"] = ("Panel", du, dv)
    for label, (name, u, v) in calls.items():
        call = lambda: api.checkedge(net, name, u, v).cpu()  # noqa: E731
        ms, hits = cs.host_median_ms(call)
        cs.log(f"checkedge {label}: median {ms:.3f} ms, {int(hits.sum())} pairs "
               f"share a group, " + cs.busy_share(call, ms, top=4))
    return 0


if __name__ == "__main__":
    sys.exit(main())
