"""Formats, precompute, the sparse Sinkhorn engine, the K cache and guards."""
