"""Models served by the port (so far DLRM of ``models.recsys``)."""
