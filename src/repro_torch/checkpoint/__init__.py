"""Atomic, asynchronous, device-agnostic checkpoints (``manager``)."""
