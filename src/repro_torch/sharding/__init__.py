from .ctx import (constrain, constrainer, full, gathered, layout, local, put_,
                  recompute_contexts, replicated)

__all__ = ["constrain", "constrainer", "full", "gathered", "layout", "local",
           "put_", "recompute_contexts", "replicated"]
