"""ops of hnswindex_torch."""
