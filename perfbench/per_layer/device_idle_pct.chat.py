"""Share of the traced span in which no device operation ran (chat cells)."""
from perfbench.readers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx)
