"""Chunked Mamba2 SSD: K6 (intra-chunk) and K7 (cross-chunk state scan)."""
