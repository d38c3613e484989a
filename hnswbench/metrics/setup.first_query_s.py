"""Seconds of the set-up's first warm-up ``knn_query``, on the host's
clock: it builds the query pack (``core/pack.make_query_pack``) and the
host mirror of the vectors that the float64 refine reads, then answers
one request."""


def read(ctx):
    s = ctx["setup"]
    if "first_query_s" not in s:
        return None
    return s["first_query_s"]
