"""Model configurations of the port, field for field those of
``repro.configs`` (so far ``dlrm_rm2`` and the recsys shape table)."""
