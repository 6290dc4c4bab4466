"""Model code: config types, layers, the LM (training forward and loss)
and the slot-batched serve steps."""
