"""Quality-and-tuning harness for the port (paper §5–§6), counterpart of
``repro.eval``.

* :mod:`repro_torch.eval.recall` — recall@k / MRR against the exact oracle
  (kernel B's LinScan on the card), per-configuration latency, and the
  (memory, latency, recall) frontier sweep.
* :mod:`repro_torch.eval.bounds` — measured per-coordinate sketch
  overestimates against the §5 theory in :mod:`repro_torch.core.theory`,
  including the drift that §4.3 churn accumulates and compaction removes.
* :mod:`repro_torch.eval.tune` — the auto-tuner behind
  ``repro_torch.launch.serve --auto-tune``.
"""

# The submodules are the API (`repro_torch.eval.tune.tune(...)`); only
# names that cannot shadow a submodule are re-exported at package level.
from repro_torch.eval import bounds, recall, tune  # noqa: F401
from repro_torch.eval.recall import (  # noqa: F401
    build_index, evaluate_index, exact_topk_ids, frontier, lever_spec,
    recall_at_k, reciprocal_rank,
)
from repro_torch.eval.bounds import (  # noqa: F401
    check_upper_bounds, churn_overestimate, per_coordinate_overestimate,
)
from repro_torch.eval.tune import TuneResult, spec_index_bytes  # noqa: F401
