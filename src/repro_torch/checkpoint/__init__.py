"""Checkpoints on disk as the reference writes them (counterpart of
``repro.checkpoint``)."""
