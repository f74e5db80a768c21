"""The generic train step (``loop``)."""
