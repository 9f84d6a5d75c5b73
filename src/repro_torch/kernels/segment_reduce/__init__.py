"""Gather + segmented reduce (K3) of the sparse Reduce."""
