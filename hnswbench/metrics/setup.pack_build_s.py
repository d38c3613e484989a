"""Seconds of the query pack's build in set-up: ``HNSWIndex._get_pack``
from the entry set's selection through ``core/pack.make_query_pack`` (the
``pack`` region), in stream time, inside the first warm-up request that
``setup.first_query_s`` times whole.

Read from the index's own ``PhaseTimer`` once set-up has ended.  An index
without the region reads nothing."""


def read(ctx):
    if "pack" not in ctx["phases"]:
        return None
    return ctx["phases"]["pack"]
