"""core of hnswindex_torch."""
