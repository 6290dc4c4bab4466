"""Model code: config types, layers, the LM and the slot-batched serve steps."""
