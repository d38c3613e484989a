"""Upper layers per forward prune in the set-up's build: the layers that
each prune of the upper-layer connect of ``core/construct``
(``upper_connect_exact``) covers.  A connect that prunes once per layer
reads 1; one that stacks a wave's layers into one prune reads the mean
layer count of the waves with upper members.

Read from the index's own ``PhaseTimer`` once set-up has ended: its tallies
``upper.layers`` over ``upper.prunes``.  An index without the tallies reads
nothing."""


def read(ctx):
    ph = ctx["phases"]
    if not ph.get("upper.prunes") or "upper.layers" not in ph:
        return None
    return ph["upper.layers"] / ph["upper.prunes"]
