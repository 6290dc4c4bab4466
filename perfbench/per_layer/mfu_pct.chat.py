"""Model FLOPs of every token the window processed over the window's
seconds at the card's bf16 peak (chat cells)."""
from perfbench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
