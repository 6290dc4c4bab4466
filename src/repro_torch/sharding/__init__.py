from .ctx import (constrain, constrainer, divisible, full, gathered, layout,
                  local, put_, recompute_contexts, replicated, whole_sequence)

__all__ = ["constrain", "constrainer", "divisible", "full", "gathered",
           "layout", "local", "put_", "recompute_contexts", "replicated",
           "whole_sequence"]
