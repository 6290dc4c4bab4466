"""The paper's mechanisms as kernel tuning on the card (the twin of
``repro.core.runahead``): Algorithm 1 as an operand-budget allocator; the
runahead *kernels* live in ``repro_torch.kernels`` and the runahead *data
pipeline* in ``repro_torch.data.pipeline``."""
from .vmem_allocator import StreamPlan, VmemPlan, allocate

__all__ = ["StreamPlan", "VmemPlan", "allocate"]
