"""Plain torch versions of the kernels (the correctness contracts).

Each function is the simplest obviously-correct implementation, ported
from ``src/repro/kernels/ref.py``. They run wherever torch runs: the CPU
tests use them as the port's path, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.csr import SENTINEL, padded_unique, sorted_isin, take_clip

_SENT = int(SENTINEL)


def intersect_count_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|row_a ∩ row_b| for SENTINEL-padded rows with unique real entries.

    a: int32[B, Ka], b: int32[B, Kb] -> int32[B]. All-pairs equality.
    """
    valid = a != _SENT
    eq = (a[:, :, None] == b[:, None, :]) & valid[:, :, None]
    return eq.sum(dim=(1, 2)).to(torch.int32)


def segmented_union_ref(
    flat: torch.Tensor, max_out: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dedup of SENTINEL-padded rows, capped at ``max_out``.

    flat: int32[..., K] (unsorted, duplicates allowed) ->
    (int32[..., max_out] sorted unique SENTINEL-padded, mask).
    """
    uniq, mask = padded_unique(flat, flat != _SENT)
    k = uniq.shape[-1]
    if k < max_out:
        pad = (0, max_out - k)
        uniq = torch.nn.functional.pad(uniq, pad, value=_SENT)
        mask = torch.nn.functional.pad(mask, pad, value=False)
    return uniq[..., :max_out], mask[..., :max_out]


def frontier_ref(
    cand: torch.Tensor, visited: torch.Tensor, max_out: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-frontier oracle: drop candidates present in the visited row,
    then dedup/sort/cap like ``segmented_union_ref``.

    cand: int32[..., Kc] SENTINEL-padded (unsorted, duplicates allowed);
    visited: int32[..., Kv] SENTINEL-padded (any order). All-pairs
    membership, O(Kc*Kv): the simplest obviously-correct form.
    """
    valid = cand != _SENT
    seen = (
        (cand[..., :, None] == visited[..., None, :]) & valid[..., :, None]
    ).any(dim=-1)
    flat = torch.where(valid & ~seen, cand, _SENT)
    return segmented_union_ref(flat, max_out)


def frontier_search_ref(
    cand: torch.Tensor, visited_sorted: torch.Tensor, max_out: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``frontier_ref`` by binary search, O(Kc log Kv): the plain path of
    ``ops.frontier_compact``. Each visited row must be sorted ascending
    (SENTINEL pads last); outputs are bit-identical to ``frontier_ref``.
    """
    valid = cand != _SENT
    seen = sorted_isin(cand, valid, visited_sorted, visited_sorted != _SENT)
    flat = torch.where(valid & ~seen, cand, _SENT)
    return segmented_union_ref(flat, max_out)


def filtered_alters_ref(
    vals: torch.Tensor,
    mask: torch.Tensor,
    node_filter: torch.Tensor,
    max_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Post-filter oracle for attribute-filtered GetNodeAlters: drop the
    alters of an UNfiltered full-width result that fail ``node_filter``,
    then re-compact to ``max_out`` sorted-unique entries."""
    keep = mask & take_clip(node_filter, torch.where(mask, vals, 0))
    flat = torch.where(keep, vals, _SENT)
    return segmented_union_ref(flat, max_out)


def filtered_degree_ref(
    vals: torch.Tensor, mask: torch.Tensor, node_filter: torch.Tensor
) -> torch.Tensor:
    """Post-filter oracle for attribute-filtered degree: count the alters
    of an UNfiltered full-width query that pass ``node_filter``."""
    keep = mask & take_clip(node_filter, torch.where(mask, vals, 0))
    return keep.sum(dim=-1).to(torch.int32)
