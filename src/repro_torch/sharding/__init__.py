from .ctx import constrain, constrainer, full, gathered, local, replicated

__all__ = ["constrain", "constrainer", "full", "gathered", "local",
           "replicated"]
