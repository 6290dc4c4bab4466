"""Synthetic LM data and the runahead prefetching loader."""
