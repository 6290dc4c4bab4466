"""Fault handling: the checkpoint-restart training driver, the straggler
watchdog and chaos plans for the serving engine."""
