"""The accelerator-side pieces of the CGRA model (``repro.core`` twins)."""
