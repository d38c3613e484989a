"""``ShardedBlockIndex`` — the block-serving index over several devices.

Counterpart of ``hnswindex_tpu/parallel/block_sharded.py``, the last rung
of the serving ladder: exact search below ~1M rows, ``BlockIndex`` up to
one device's memory, per-shard block tables beyond.

* Blocks are laid out as ``BlockIndex`` lays them out (``block.
  _layout_blocks``: global k-means, each cluster cut into blocks), padded
  with empty blocks to a multiple of S and dealt round-robin: global block
  ``gb`` lives on shard ``gb % S`` at local row ``gb // S``.
* The centroid table is small and routing runs once, on the first device
  (the reference replicates it on every shard).
* Each shard takes the probes it owns, compacted to the front of each
  query's row (-1 pads), and scores them with kernel K2 through
  ``block._score_blocks_panel`` (on a CPU tensor the K2 wrapper runs its
  plain version); the shards' oversampled panels merge on the first
  device and the merged ids are refined in float64 on the host.  K2 takes
  the norms from the tiles, so no norm table is kept.

Global ids are corpus rows.  The class is a ``BlockIndex`` whose device
tables are dealt across shards: the host mirrors, the placement rules, the
evictions, ``needs_rebuild``/``rebuild`` and the float64 refine are
``BlockIndex``'s; only the installation, growth and upload of the device
tables and ``query_device`` are its own.  A registered metric is refused.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..block import BlockIndex, _route_exact, _score_blocks_panel
from ..core.snapshot import npz_path
from ..ops import distance as dst
from ..params import HNSWParameters
from .sharded import resolve_devices


class ShardedBlockIndex(BlockIndex):
    """Bulk-built block index sharded across ``devices`` (see module
    docstring).  Same query contract as ``BlockIndex``: ``knn_query(q, k,
    n_probe)`` -> (ids, dists), -1/NaN padded, float64-refined."""

    def __init__(self, dim: int, metric: str = "sq_euclid",
                 parameters: Optional[HNSWParameters] = None,
                 block_size: int = 128, kmeans_iters: int = 6,
                 devices: Optional[Sequence] = None):
        dst.check_metric(metric)
        if dst.is_custom(metric):
            raise ValueError(
                "ShardedBlockIndex requires a dot-decomposable metric")
        self.dim = int(dim)
        self.metric = metric
        self.params = parameters or HNSWParameters()
        self.block_size = int(block_size)
        self.kmeans_iters = int(kmeans_iters)
        self.devices = resolve_devices(devices)
        self.n_shards = len(self.devices)
        # k-means, routing and the merge run on the first device
        self.device = self.devices[0]
        self.router = "exact"
        self._built = False

    # -- device tables ---------------------------------------------------

    def _install(self, blk_ids: np.ndarray, blk_vecs: np.ndarray,
                 next_id: int) -> None:
        """Host mirrors and per-shard device tables from a global block
        layout (shared by build, rebuild and deserialize), padded with
        empty blocks so that every shard owns the same row count."""
        S = self.n_shards
        BS = self.block_size
        NB = blk_ids.shape[0]
        NBp = -(-NB // S) * S
        if NBp != NB:
            blk_ids = np.concatenate(
                [blk_ids, np.full((NBp - NB, BS), -1, np.int32)])
            blk_vecs = np.concatenate(
                [blk_vecs, np.zeros((NBp - NB, BS, self.dim), np.float32)])
        self._install_host(blk_ids, blk_vecs, next_id)
        # shard s holds global blocks s, s + S, s + 2S, ...
        self._blk_vecs, self._blk_ids, self._blk_fill = [], [], []
        for s, d in enumerate(self.devices):
            for table, host in ((self._blk_vecs, self._h_vecs),
                                (self._blk_ids, self._h_ids),
                                (self._blk_fill, self._h_fill)):
                table.append(torch.as_tensor(
                    np.ascontiguousarray(host[s::S])).to(d))
        self._push_router()
        self._built = True

    def _push_router(self) -> None:
        """The centroid table on the first device; empty blocks (padding,
        growth headroom) are masked out of routing."""
        self._cents = self._to_dev(self._h_cents)
        self._cent_norms = dst.norm_data(self.metric, self._cents)
        self._cent_valid = self._to_dev(self._h_fill > 0)

    def _touch_device(self, blocks) -> None:
        """Upload the touched global blocks to their (shard, row) slots."""
        tb = np.unique(np.asarray(blocks, np.int64))
        if tb.size == 0:
            return
        S = self.n_shards
        for s, d in enumerate(self.devices):
            mine = tb[tb % S == s]
            if mine.size == 0:
                continue
            rw = torch.as_tensor(mine // S).to(d)
            self._blk_vecs[s][rw] = torch.as_tensor(self._h_vecs[mine]).to(d)
            self._blk_ids[s][rw] = torch.as_tensor(self._h_ids[mine]).to(d)
            self._blk_fill[s][rw] = torch.as_tensor(self._h_fill[mine]).to(d)
        self._push_router()

    def _grow_blocks(self, n_new: int) -> None:
        """Extend every shard's table by the same row count (the global
        count grows by a multiple of S; new global blocks start at the old
        count, so every existing block keeps its (shard, row))."""
        S = self.n_shards
        BS = self.block_size
        grow_rows = -(-max(n_new, 16, self.n_blocks // 4) // S)  # a shard
        self._grow_host(grow_rows * S)
        for s in range(S):
            v, i, f = self._blk_vecs[s], self._blk_ids[s], self._blk_fill[s]
            self._blk_vecs[s] = torch.cat(
                [v, v.new_zeros((grow_rows, BS, self.dim))])
            self._blk_ids[s] = torch.cat([i, i.new_full((grow_rows, BS), -1)])
            self._blk_fill[s] = torch.cat([f, f.new_zeros(grow_rows)])
        self._push_router()

    # -- persistence -----------------------------------------------------

    def serialize(self, path: str) -> None:
        """The corpus and the block layout (ids only) to one ``.npz`` in
        the reference's format (a removed row is written as zeros: no
        layout refers to it)."""
        self._require_built()
        header = {"dim": self.dim, "metric": self.metric,
                  "block_size": self.block_size, "count": int(self.count),
                  "n_blocks": int(self.n_blocks),
                  "random_seed": int(self.params.random_seed),
                  "kmeans_iters": int(self.kmeans_iters)}
        vectors = np.zeros((self._next_id, self.dim), np.float32)
        live = np.flatnonzero(self._id_to_pos >= 0)
        vectors[live] = self._h_vecs.reshape(-1, self.dim)[
            self._id_to_pos[live]]
        np.savez_compressed(
            path,
            header=np.frombuffer(json.dumps(header).encode(), np.uint8),
            vectors=vectors,
            blk_ids=self._h_ids)

    @classmethod
    def deserialize(cls, path: str, devices: Optional[Sequence] = None
                    ) -> "ShardedBlockIndex":
        """Reload the stored layout onto ``devices`` (a snapshot without a
        layout is laid out again)."""
        with np.load(npz_path(path)) as z:
            header = json.loads(bytes(z["header"]).decode())
            vecs = z["vectors"]
            blk_ids = z["blk_ids"] if "blk_ids" in z.files else None
        p = HNSWParameters(random_seed=header.get("random_seed", 31337))
        ix = cls(header["dim"], header["metric"], parameters=p,
                 block_size=header["block_size"],
                 kmeans_iters=header.get("kmeans_iters", 6),
                 devices=devices)
        if blk_ids is None:
            ix.build(vecs)
            return ix
        safe = np.clip(blk_ids, 0, max(0, vecs.shape[0] - 1))
        blk_vecs = np.where((blk_ids >= 0)[:, :, None], vecs[safe], 0.0)
        ix._install(blk_ids, blk_vecs.astype(np.float32),
                    next_id=vecs.shape[0])
        return ix

    # -- query -----------------------------------------------------------

    def _shard_probes(self, gb: torch.Tensor, s: int) -> torch.Tensor:
        """Shard ``s``'s local probe table from the global one: the blocks
        it owns as local rows, moved to the front of each query's row,
        -1 padded to the widest row (at least one column)."""
        S = self.n_shards
        mine = (gb >= 0) & (gb % S == s)
        order = torch.argsort((~mine).to(torch.int8), dim=1, stable=True)
        width = max(1, int(mine.sum(dim=1).max()))
        order = order[:, :width]
        local = torch.where(torch.gather(mine, 1, order),
                            torch.gather(gb, 1, order) // S, -1)
        return local.to(torch.int32)

    def query_device(self, q: torch.Tensor, k: int, n_probe: int = 32):
        """Route on the first device, score each shard's owned probes with
        K2, merge the shards' panels on the first device.  Returns
        ``(dists, ids)`` of width ``min(max(2k, 32), probed rows)`` on the
        first device, for ``knn_query``'s float64 refine."""
        n_probe = min(n_probe, self.n_blocks)
        gb = _route_exact(self.metric, self._cents, self._cent_norms,
                          q.to(self.device), n_probe, self._cent_valid)
        vals, ids = [], []
        for s, d in enumerate(self.devices):
            v, i = _score_blocks_panel(
                self.metric, self._blk_vecs[s], self._blk_ids[s],
                self._blk_fill[s], q.to(d), self._shard_probes(gb, s).to(d),
                k)
            vals.append(v.to(self.device))
            ids.append(i.long().to(self.device))
        vals = torch.cat(vals, dim=1)
        ids = torch.cat(ids, dim=1)
        width = min(max(2 * k, 32), n_probe * self.block_size,
                    vals.shape[1])
        order = torch.argsort(vals, dim=1, stable=True)[:, :width]
        return torch.gather(vals, 1, order), torch.gather(ids, 1, order)
