"""Models of the port: the recsys family (``models.recsys``: DLRM, DIN,
SASRec, MIND), served and trained."""
