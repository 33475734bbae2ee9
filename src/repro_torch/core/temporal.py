"""Temporal network sequences: yearly snapshots of one node universe.

Register data is yearly: kinship, household and workplace layers change
over time while the population persists. A ``TemporalNetwork`` is an
ordered sequence of Networks sharing one node universe, with:

* ``at(year)`` — the snapshot;
* ``edge_years`` (when were u and v connected, pseudo-projected for
  two-mode layers) and ``first_contact`` — through the snapshots' edge
  queries, so on the card the intersect kernel answers them;
* ``window(y0, y1)`` — a union network over a year range, layers renamed
  ``<name>@<year>``, so multilayer queries and walks run across time;
* per-year memory accounting (``memory_by_year``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from .memory import memory_report
from .network import Network
from .nodeset import Nodeset


@dataclass(frozen=True)
class TemporalNetwork:
    nodeset: Nodeset
    snapshots: tuple[Network, ...]
    years: tuple[int, ...]

    @staticmethod
    def from_snapshots(
        pairs: Sequence[tuple[int, Network]]
    ) -> "TemporalNetwork":
        pairs = sorted(pairs, key=lambda p: p[0])
        years = tuple(y for y, _ in pairs)
        nets = tuple(n for _, n in pairs)
        if len(set(years)) != len(years):
            raise ValueError("duplicate years")
        n0 = nets[0].nodeset
        for n in nets[1:]:
            if n.n_nodes != n0.n_nodes:
                raise ValueError("snapshots must share the node universe")
        return TemporalNetwork(nodeset=n0, snapshots=nets, years=years)

    def at(self, year: int) -> Network:
        try:
            return self.snapshots[self.years.index(year)]
        except ValueError:
            raise KeyError(f"no snapshot for {year}; have {self.years}")

    def window(self, y0: int, y1: int) -> Network:
        """Union network over [y0, y1]: layers renamed '<layer>@<year>'."""
        out = Network(nodeset=self.nodeset, layers=(), layer_names=())
        for y, net in zip(self.years, self.snapshots):
            if y0 <= y <= y1:
                for name, layer in zip(net.layer_names, net.layers):
                    out = out.with_layer(f"{name}@{y}", layer)
        if not out.layers:
            raise ValueError(f"no snapshots in [{y0}, {y1}]")
        return out

    def edge_years(self, layer_name: str, u: int, v: int) -> list[int]:
        """Years in which (u, v) are connected in the given layer
        (pseudo-projected for two-mode layers)."""
        return [
            y for y, net in zip(self.years, self.snapshots)
            if layer_name in net.layer_names
            and bool(net.check_edge(layer_name, [u], [v])[0])
        ]

    def first_contact(
        self, u: int, v: int, layer_names: Sequence[str] | None = None
    ) -> int | None:
        """First year in which u and v share ANY selected layer."""
        for y, net in zip(self.years, self.snapshots):
            names = layer_names or net.layer_names
            present = [n for n in names if n in net.layer_names]
            if present and bool(net.check_edge_any([u], [v], present)[0]):
                return y
        return None

    def memory_by_year(self) -> dict[int, int]:
        return {
            y: memory_report(net).total_nbytes
            for y, net in zip(self.years, self.snapshots)
        }

    @property
    def nbytes(self) -> int:
        return self.nodeset.nbytes + sum(
            sum(l.nbytes for l in n.layers) for n in self.snapshots
        )
