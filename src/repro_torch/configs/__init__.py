"""Model configurations of the port, field for field those of
``repro.configs``: the recsys family (``dlrm_rm2``, ``din``, ``sasrec``,
``mind``), ``sinnamon_engine``, the recsys shape table and the arch
registry."""
