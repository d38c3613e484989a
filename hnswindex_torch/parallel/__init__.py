"""Sharded front ends: a corpus split by row over several torch devices,
each shard an independent graph (``sharded.ShardedIndex``) or block table
(``block_sharded.ShardedBlockIndex``), answers merged on the first
device."""

from .block_sharded import ShardedBlockIndex
from .sharded import ShardedIndex

__all__ = ["ShardedIndex", "ShardedBlockIndex"]
