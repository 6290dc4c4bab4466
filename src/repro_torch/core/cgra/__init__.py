"""The §3.4 cache-grid profiler on the card (``repro.core.cgra`` twins)."""
