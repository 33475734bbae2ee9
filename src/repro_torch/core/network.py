"""Multilayer mixed-mode Network container + mode-agnostic query API.

A Network references a Nodeset and holds named layers, each one-mode or
two-mode. Both layer classes implement the shared query protocol, so the
multilayer queries below work across layers of different modes without
branching on mode. Query ids become int32 tensors on the network's
device; a node filter is uploaded once per call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from . import dispatch
from .csr import take_clip, to_tensor
from .layers import LayerOneMode, LayerTwoMode
from .nodeset import Nodeset, create_nodeset, node_filter_mask

Layer = LayerOneMode | LayerTwoMode


@dataclass(frozen=True)
class Network:
    nodeset: Nodeset
    layers: tuple[Layer, ...]
    layer_names: tuple[str, ...]

    # -- container ----------------------------------------------------------

    @property
    def n_nodes(self) -> int:
        return self.nodeset.n_nodes

    @property
    def device(self) -> torch.device:
        return self.nodeset.device

    def layer(self, name: str) -> Layer:
        try:
            return self.layers[self.layer_names.index(name)]
        except ValueError:
            raise KeyError(
                f"no layer {name!r}; have {self.layer_names}"
            ) from None

    def with_layer(self, name: str, layer: Layer) -> "Network":
        if layer.n_nodes != self.n_nodes:
            raise ValueError(
                f"layer has {layer.n_nodes} nodes, network has {self.n_nodes}"
            )
        if name in self.layer_names:
            i = self.layer_names.index(name)
            return Network(
                nodeset=self.nodeset,
                layers=self.layers[:i] + (layer,) + self.layers[i + 1 :],
                layer_names=self.layer_names,
            )
        return Network(
            nodeset=self.nodeset,
            layers=self.layers + (layer,),
            layer_names=self.layer_names + (name,),
        )

    def without_layer(self, name: str) -> "Network":
        i = self.layer_names.index(name)
        return Network(
            nodeset=self.nodeset,
            layers=self.layers[:i] + self.layers[i + 1 :],
            layer_names=self.layer_names[:i] + self.layer_names[i + 1 :],
        )

    def with_nodeset(self, nodeset: Nodeset) -> "Network":
        """Swap the nodeset (attribute mutations rebind functionally)."""
        if nodeset.n_nodes != self.n_nodes:
            raise ValueError(
                f"nodeset has {nodeset.n_nodes} nodes, network has "
                f"{self.n_nodes}"
            )
        return Network(
            nodeset=nodeset, layers=self.layers, layer_names=self.layer_names
        )

    def _select(self, layer_names: Sequence[str] | None) -> tuple[Layer, ...]:
        if layer_names is None:
            return self.layers
        return tuple(self.layer(n) for n in layer_names)

    def _batch(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            x = x.to(device=self.device, dtype=torch.int32)
        else:
            x = to_tensor(np.asarray(x, dtype=np.int32), self.device)
        return x[None] if x.dim() == 0 else x

    def _filter(self, node_filter) -> torch.Tensor | None:
        return dispatch.device_mask(
            node_filter_mask(node_filter, self.n_nodes), self.device
        )

    # -- mode-agnostic multilayer queries ------------------------------------

    def check_edge(self, layer_name: str, u, v) -> torch.Tensor:
        return self.layer(layer_name).check_edge(self._batch(u), self._batch(v))

    def edge_value(self, layer_name: str, u, v, node_filter=None) -> torch.Tensor:
        return self.layer(layer_name).edge_value(
            self._batch(u), self._batch(v), node_filter=self._filter(node_filter)
        )

    def check_edge_any(
        self, u, v,
        layer_names: Sequence[str] | None = None,
        node_filter=None,
    ) -> torch.Tensor:
        """Edge existence across layers of any mode (OR-combined).

        With ``node_filter`` the result is True only when ``v`` passes
        the filter; filtered-out pairs skip the bucketed work.
        """
        u, v = self._batch(u), self._batch(v)
        nf = self._filter(node_filter)
        out = torch.zeros(u.shape, dtype=torch.bool, device=self.device)
        for layer in self._select(layer_names):
            out = out | layer.check_edge(u, v, node_filter=nf)
        return out

    def node_alters(
        self,
        u,
        max_alters: int,
        layer_names: Sequence[str] | None = None,
        node_filter=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Union of alters across selected layers (mixed modes welcome).

        Returns (int32[B, max_alters] sorted padded, mask). Two-mode
        layers contribute pseudo-projected alters (degree-bucketed), and
        the cross-layer merge goes through ``dispatch.union_rows``.
        ``node_filter`` keeps only alters passing a predicate, with the
        ``max_alters`` cap applying post-filter.
        """
        u = self._batch(u)
        nf = self._filter(node_filter)
        parts, masks = [], []
        for layer in self._select(layer_names):
            a, m = layer.node_alters(u, max_alters, node_filter=nf)
            parts.append(a)
            masks.append(m)
        vals = torch.cat(parts, dim=-1)
        mask = torch.cat(masks, dim=-1)
        return dispatch.union_rows(vals, mask, max_alters)

    def degree(
        self, u, layer_names: Sequence[str] | None = None, node_filter=None,
    ) -> torch.Tensor:
        """Summed per-layer degree (two-mode: membership count).

        With ``node_filter``, the per-layer count of neighbors (one-mode) /
        distinct co-members (two-mode) passing the filter, summed.
        """
        u = self._batch(u)
        nf = self._filter(node_filter)
        total = torch.zeros(u.shape, dtype=torch.int32, device=self.device)
        for layer in self._select(layer_names):
            if nf is None:
                total = total + take_clip(layer.degrees(), u)
            else:
                total = total + layer.filtered_degree(u, nf)
        return total

    # -- batched traversal (core/traversal.py) -------------------------------

    def khop(
        self,
        sources,
        k: int,
        *,
        max_frontier: int | None = None,
        max_alters_per_node: int | None = None,
        layer_names: Sequence[str] | None = None,
        node_filter=None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Batched k-hop neighborhoods -> (nodes, mask, hop_of_slot).

        Frontier-based multi-source BFS through the degree-bucketed
        dispatch — see ``traversal.khop_neighborhood`` for the layout
        (slot 0 = source, then k sorted hop groups of ``max_frontier``)."""
        from .traversal import khop_neighborhood

        return khop_neighborhood(
            self, sources, k, max_frontier=max_frontier,
            max_alters_per_node=max_alters_per_node,
            layer_names=layer_names, node_filter=node_filter,
        )

    def ego_batch(
        self,
        egos,
        max_alters: int,
        *,
        k: int = 1,
        max_alters_per_node: int | None = None,
        layer_names: Sequence[str] | None = None,
        node_filter=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched k-hop ego networks -> (int32[B, max_alters], dedup mask).

        Sorted-unique alters within k hops of each ego (ego excluded);
        every alter appears once however many paths reach it."""
        from .traversal import ego_batch

        return ego_batch(
            self, egos, max_alters, k=k,
            max_alters_per_node=max_alters_per_node,
            layer_names=layer_names, node_filter=node_filter,
        )

    # -- bookkeeping ----------------------------------------------------------

    def compacted(self) -> "Network":
        """Fold every layer's delta overlay into a rebuilt base CSR.

        Returns ``self`` unchanged when no layer carries an overlay, so
        callers can use object identity to detect whether compaction did
        anything. Query results are bit-identical before and after.
        """
        from .layers import compact_layer, has_overlay

        if not any(has_overlay(l) for l in self.layers):
            return self
        return Network(
            nodeset=self.nodeset,
            layers=tuple(
                compact_layer(l) if has_overlay(l) else l
                for l in self.layers
            ),
            layer_names=self.layer_names,
        )

    @property
    def nbytes(self) -> int:
        return self.nodeset.nbytes + sum(l.nbytes for l in self.layers)


def create_network(nodeset: Nodeset | int, device=None) -> Network:
    if isinstance(nodeset, int):
        nodeset = create_nodeset(nodeset, device=device)
    elif device is not None and torch.device(device).type != nodeset.device.type:
        raise ValueError(
            f"nodeset lives on {nodeset.device}, network asked for {device}"
        )
    return Network(nodeset=nodeset, layers=(), layer_names=())
