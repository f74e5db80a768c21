"""Candidate generation's share of its roofline: over the staged query
batches, the least time Algorithm 6's candidate generation can take on
each batch's inputs (``bench/roofline``) over the ``sketch_scan`` +
``topk_merge`` spans, in %."""

from roofline.candidates import candidate_work
from roofline.peaks import least_seconds


def read(run):
    if run.posting is None or not run.spans:
        return None
    cfg = run.cfg
    least = spent = 0.0
    for (q_idx, q_val), t in zip(run.staged_queries, run.spans):
        nbytes, ops = candidate_work(
            q_idx, q_val, run.maps, int(cfg["index"]["m"]), run.two_sided,
            run.posting, int(cfg["index"]["capacity"]), run.cell_bytes,
            int(cfg["serving"]["kprime"]))
        t_min = least_seconds(nbytes, ops, run.device_kind)
        if t_min is None:
            return None
        least += t_min
        spent += (t["sketch_scan"] + t["topk_merge"]) * 1e-3
    return 100.0 * least / spent if spent else None
