"""Fault handling: the checkpoint-restart training driver, the straggler
watchdog, chaos plans, the sweep's task supervisor and its lease-based
work claiming."""
