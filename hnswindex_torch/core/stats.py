"""Graph introspection: per-layer degree statistics and weak components.

Counterpart of ``hnswindex_tpu/core/stats.py`` (the reference's
HNSWInfo.cs:5-53 and GraphNavigator.cs:331-419), with the same records
and the same figures:

* ``graph_info`` — per layer, over the active rows on it: node count,
  out-degree max / min / mean / median and the same for in-degrees, which
  one ``scatter_add_`` over the out-edge table recovers (the reference
  keeps explicit in-edge lists).  The median of an even count is the two
  middle ranks' integer mean (HNSWInfo.cs:45-51).  Without removals the
  in-edge figures are zero, as the reference reports them.  The
  reference's 1,024-bucket histogram only kept a device readback small;
  here the figures are computed exactly on the device and read in one
  transfer a layer.
* ``connected_component_counts`` — min-label propagation over the
  undirected closure (pull along out-edges by a gather, push along
  in-edges by a ``scatter_reduce_`` "amin"), two pointer jumps a round
  (``label <- label[label]``), so a component of any shape converges in
  O(log C) rounds; the host asks once a round whether a label changed.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from .graph import GraphConfig, GraphState, nbr_slice


@dataclasses.dataclass
class LayerInfo:
    """Mirror of HNSWInfo.LayerInfo (HNSWInfo.cs:18-52)."""
    layer_id: int
    nodes_count: int
    max_out_edges: int
    min_out_edges: int
    max_in_edges: int
    min_in_edges: int
    avg_out_edges: float
    avg_in_edges: float
    out_edges_median: int
    in_edges_median: int


@dataclasses.dataclass
class HNSWInfo:
    """Mirror of HNSWInfo (HNSWInfo.cs:5-16)."""
    layers: List[LayerInfo]


def _on_layer(state: GraphState, layer: int) -> torch.Tensor:
    return state.active & (state.level >= layer)


def in_degrees(state: GraphState, layer: int) -> torch.Tensor:
    """(C,) int64 in-degree of every row at ``layer``: edges out of the
    active rows on the layer, counted at their targets."""
    C = state.capacity
    nbr_l, _ = nbr_slice(state, layer)
    edge = (nbr_l >= 0) & _on_layer(state, layer)[:, None]
    tgt = torch.where(edge, nbr_l.long(), C).flatten()
    cnt = torch.zeros((C + 1,), dtype=torch.int64, device=state.device)
    cnt.scatter_add_(0, tgt, torch.ones_like(tgt))
    return cnt[:C]


def _median(sorted_vals: torch.Tensor) -> torch.Tensor:
    n = sorted_vals.shape[0]
    if n % 2:
        return sorted_vals[n // 2]
    return torch.div(sorted_vals[n // 2 - 1] + sorted_vals[n // 2], 2,
                     rounding_mode="floor")


def _layer_figures(state: GraphState, layer: int):
    """[n, out max, out min, in max, in min, out sum, in sum, out median,
    in median] of one layer as host ints, or None for an empty layer."""
    on = _on_layer(state, layer)
    _, deg_l = nbr_slice(state, layer)
    od = deg_l[on].long()
    if od.numel() == 0:
        return None
    idg = in_degrees(state, layer)[on]
    fig = torch.stack([
        torch.tensor(od.numel(), device=od.device),
        od.max(), od.min(), idg.max(), idg.min(), od.sum(), idg.sum(),
        _median(torch.sort(od).values), _median(torch.sort(idg).values)])
    return fig.tolist()


def graph_info(cfg: GraphConfig, state: GraphState,
               report_in_edges: bool = True) -> HNSWInfo:
    """Per-layer degree statistics over layers 0 .. level(entry point)
    (HNSWIndex.GetInfo, HNSWIndex.cs:192); empty layers are left out.
    ``report_in_edges=False`` reports zero in-edge figures (the reference
    with AllowRemovals=false keeps no in-edge lists)."""
    ep = int(state.ep)
    if ep < 0:
        return HNSWInfo(layers=[])
    layers = []
    for layer in range(int(state.level[ep]) + 1):
        fig = _layer_figures(state, layer)
        if fig is None:
            continue
        n, omax, omin, imax, imin, osum, isum, omed, imed = fig
        if not report_in_edges:
            imax = imin = isum = imed = 0
        layers.append(LayerInfo(
            layer_id=layer, nodes_count=n,
            max_out_edges=omax, min_out_edges=omin,
            max_in_edges=imax, min_in_edges=imin,
            avg_out_edges=osum / n, avg_in_edges=isum / n,
            out_edges_median=omed, in_edges_median=imed))
    return HNSWInfo(layers=layers)


def components_iter_bound(capacity: int) -> int:
    """Round cap of the label propagation: with two pointer jumps a round
    the label horizon at least quadruples, so ~log4(C) rounds suffice on
    any topology; 4 x log2(C) is a wide net (reference bound)."""
    return 4 * max(4, int(capacity).bit_length() + 2)


def components_at_layer(state: GraphState, layer: int, max_iters: int):
    """Weak components of the active rows at ``layer``.  Returns
    (component count, whether any row is on the layer, rounds run)."""
    C = state.capacity
    dev = state.device
    nbr_l, _ = nbr_slice(state, layer)
    on = _on_layer(state, layer)
    ids = torch.arange(C, device=dev)
    labels = torch.where(on, ids, C)
    tgt = nbr_l.long().clamp(0, C - 1)
    # only edges between two rows on the layer carry a label
    edge = (nbr_l >= 0) & on[:, None] & on[tgt]
    push_to = torch.where(edge, nbr_l.long(), C).flatten()

    def jump(lab):
        return torch.minimum(lab, lab[lab.clamp(0, C - 1)])

    rounds = 0
    while rounds < max_iters:
        pull = torch.where(edge, labels[tgt], C).min(dim=1).values
        new = torch.cat([torch.minimum(labels, pull),
                         labels.new_full((1,), C)])
        # push each row's label to its out-neighbours (their in-edges)
        new.scatter_reduce_(0, push_to,
                            labels[:, None].expand_as(nbr_l).flatten(),
                            reduce="amin")
        new = jump(jump(new[:C]))
        rounds += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    roots = on & (labels == ids)
    return int(roots.sum()), bool(on.any()), rounds


def connected_component_counts(cfg: GraphConfig,
                               state: GraphState) -> List[int]:
    """Weak-component count of each layer 0 .. level(entry point)
    (GetConnectedComponentCounts, HNSWIndex.cs:202-205); an empty graph
    gives [] (GraphNavigator.cs:333)."""
    if int(state.count) == 0 or int(state.ep) < 0:
        return []
    bound = components_iter_bound(state.capacity)
    counts = []
    for layer in range(int(state.level[int(state.ep)]) + 1):
        c, nonempty, _ = components_at_layer(state, layer, bound)
        counts.append(c if nonempty else 0)
    return counts
