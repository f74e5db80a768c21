"""Model configurations of the port, field for field those of
``repro.configs``: the LM family (``deepseek_67b``, ``stablelm_12b``,
``gemma3_27b``, ``llama4_scout_17b_a16e``, ``moonshot_v1_16b_a3b``), the
recsys family (``dlrm_rm2``, ``din``, ``sasrec``, ``mind``),
``sinnamon_engine``, the LM and recsys shape tables and the arch
registry."""
