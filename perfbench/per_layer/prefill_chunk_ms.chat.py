"""Median wall ms of the window's prefill chunks (chat cells)."""
from perfbench.readers import step_ms


def read(ctx):
    return step_ms(ctx, "prefill")
