"""utils of hnswindex_torch."""
