from .ctx import (constrain, constrainer, divisible, full, gathered, layout,
                  local, put_, recompute_contexts, replicated)

__all__ = ["constrain", "constrainer", "divisible", "full", "gathered",
           "layout", "local", "put_", "recompute_contexts", "replicated"]
