"""Step assembly for the serving engine."""
