"""Fault handling shared by the serving engine."""
