"""AdamW and gradient compression for the port's training step."""
