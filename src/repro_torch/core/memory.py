"""Memory accounting — the paper's Table 1 methodology.

``memory_report(net)`` sums the bytes of each layer's tensors, computes
each two-mode layer's equivalent projected edge count (paper Eq. 1) and
the compression ratio of pseudo-projection storage against a materialized
8 B/edge projection. Beside those analytic numbers it reports what the OS
charges the process: the current resident set (``/proc/self/status``
VmRSS) and the lifetime peak (``getrusage`` ru_maxrss). Tensors on the
card count in the analytic bytes but not in the host's resident set.
"""

from __future__ import annotations

import resource
from dataclasses import dataclass, field
from pathlib import Path

from .layers import LayerTwoMode
from .network import Network
from .projection import projection_nbytes

__all__ = ["memory_report", "MemoryReport", "resident_rss", "peak_rss"]


def resident_rss() -> int:
    """Current resident set size in bytes (VmRSS; 0 where /proc is absent)."""
    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def peak_rss() -> int:
    """Lifetime peak resident set size of this process, in bytes
    (``ru_maxrss`` is in KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


@dataclass
class LayerReport:
    name: str
    mode: int
    nbytes: int
    n_edges: int  # one-mode: edges; two-mode: memberships
    equivalent_projected_edges: int = 0
    projection_nbytes: int = 0
    compression_ratio: float = 1.0


@dataclass
class MemoryReport:
    total_nbytes: int
    nodeset_nbytes: int
    layers: list[LayerReport] = field(default_factory=list)
    resident_rss_bytes: int = 0
    peak_rss_bytes: int = 0

    def pretty(self) -> str:
        lines = [
            f"{'layer':<18}{'mode':>5}{'MB':>12}{'edges/memb':>16}"
            f"{'eq. projected':>18}{'ratio':>12}"
        ]
        for l in self.layers:
            ratio = f"{l.compression_ratio:,.0f}:1" if l.mode == 2 else "-"
            eq = f"{l.equivalent_projected_edges:,}" if l.mode == 2 else "-"
            lines.append(
                f"{l.name:<18}{l.mode:>5}{l.nbytes / 2**20:>12.1f}"
                f"{l.n_edges:>16,}{eq:>18}{ratio:>12}"
            )
        lines.append(
            f"{'nodeset attrs':<18}{'':>5}{self.nodeset_nbytes / 2**20:>12.1f}"
        )
        lines.append(f"TOTAL {self.total_nbytes / 2**20:,.1f} MB (analytic)")
        if self.resident_rss_bytes:
            lines.append(
                f"RSS   {self.resident_rss_bytes / 2**20:,.1f} MB resident"
                f" / {self.peak_rss_bytes / 2**20:,.1f} MB peak (process)"
            )
        return "\n".join(lines)


def memory_report(net: Network) -> MemoryReport:
    reports = []
    for name, layer in zip(net.layer_names, net.layers):
        if isinstance(layer, LayerTwoMode):
            proj = projection_nbytes(layer)
            reports.append(LayerReport(
                name=name, mode=2, nbytes=layer.nbytes,
                n_edges=layer.n_memberships,
                equivalent_projected_edges=layer.equivalent_projected_edges(),
                projection_nbytes=proj,
                compression_ratio=proj / max(layer.nbytes, 1),
            ))
        else:
            reports.append(LayerReport(
                name=name, mode=1, nbytes=layer.nbytes, n_edges=layer.n_edges,
            ))
    return MemoryReport(
        total_nbytes=net.nbytes,
        nodeset_nbytes=net.nodeset.nbytes,
        layers=reports,
        resident_rss_bytes=resident_rss(),
        peak_rss_bytes=peak_rss(),
    )
