"""Pull-time gauge collectors wiring live index health into a registry.

`install_engine_gauges(index)` registers a weakref-backed collector that,
on every scrape/snapshot, publishes live-slot counts, free-list depth,
per-shard skew, measured + analytic index bytes, dirty-column count, and
(for durable indexes) WAL/snapshot freshness.  The collector holds only a
weak reference — when the index is garbage collected it returns False and
the registry prunes it, so short-lived test indexes never pin memory or
leak label sets.
"""

from __future__ import annotations

import time
import weakref

from repro_torch.obs import metrics as _metrics

__all__ = ["install_engine_gauges", "install_recorder_gauges"]


def install_engine_gauges(index, registry=None, name: str = "index"):
    """Attach health gauges for `index` (SinnamonIndex, ShardedSinnamonIndex,
    or a durable subclass) to `registry` (default: process-global).  The
    `name` label keeps multiple indexes in one registry distinct."""
    registry = registry if registry is not None else _metrics.get_registry()
    ref = weakref.ref(index)
    labels = {"index": str(name)}

    def _collect():
        ix = ref()
        if ix is None:
            return False
        _publish(registry, ix, labels)
        return True

    registry.add_collector(_collect)
    return _collect


def install_recorder_gauges(recorder, registry=None):
    """Attach pull-time ring-occupancy gauges for a `FlightRecorder`.

    Same weakref-collector pattern as the engine gauges: nothing runs on
    the request path, the scrape reads `recorder.stats()`."""
    registry = registry if registry is not None else _metrics.get_registry()
    ref = weakref.ref(recorder)

    def _collect():
        rec = ref()
        if rec is None:
            return False
        stats = rec.stats()
        registry.gauge(
            "repro_recorder_ring_size",
            "Request traces currently retained in the flight-recorder "
            "ring.").set(stats["ring_size"])
        registry.gauge(
            "repro_recorder_ring_capacity",
            "Flight-recorder ring capacity.").set(stats["capacity"])
        registry.gauge(
            "repro_recorder_tail_threshold_ms",
            "Current tail-retention latency threshold (-1 until enough OK "
            "samples).").set(
            -1.0 if stats["tail_threshold_ms"] is None
            else stats["tail_threshold_ms"])
        return True

    registry.add_collector(_collect)
    return _collect


def _publish(registry, ix, labels):
    def gauge(metric, help_text="", **extra):
        return registry.gauge(metric, help_text, labels={**labels, **extra})

    spec = ix.spec
    n_shards = getattr(ix, "n_shards", 1)
    capacity = spec.capacity * n_shards
    gauge("repro_engine_live_docs", "Documents currently live in the index.").set(ix.size)
    gauge("repro_engine_capacity_slots", "Total slot capacity across shards.").set(capacity)

    free = getattr(ix, "_free", None)
    if free is not None:
        if free and isinstance(free[0], list):  # sharded: one free list per shard
            depths = [len(f) for f in free]
            gauge("repro_engine_free_slots", "Free (recyclable) slots.").set(sum(depths))
            live = [spec.capacity - d for d in depths]
            for s, n_live in enumerate(live):
                gauge("repro_engine_shard_live_slots",
                      "Live slots on one shard.", shard=str(s)).set(n_live)
            gauge("repro_engine_shard_skew_slots",
                  "max-min live slots across shards (routing imbalance).",
                  ).set(max(live) - min(live) if live else 0)
        else:
            gauge("repro_engine_free_slots", "Free (recyclable) slots.").set(len(free))

    # Tiered indexes: one TieredVecStore (single-device `.tiered`) or one
    # per corpus shard (sharded `.tiers`); the placeholder state.store is
    # zero-row, so `storage` below reports the device chunk cache instead.
    tiers = ([ix.tiered] if hasattr(ix, "tiered")
             else list(getattr(ix, "tiers", ())))
    if tiers:
        gauge("repro_tier_resident_bytes",
              "Device bytes of raw rows resident in the tier chunk caches.",
              ).set(sum(t.device_bytes() for t in tiers))
        gauge("repro_tier_resident_chunks",
              "Chunks currently resident across all tier caches.",
              ).set(sum(t.resident_chunks() for t in tiers))
        gauge("repro_tier_host_bytes",
              "Host-RAM bytes of the cold raw-row backing store.",
              ).set(sum(t.host_bytes() for t in tiers))

    state = getattr(ix, "state", None)
    if state is not None:
        def nbytes(t):
            return t.numel() * t.element_size()

        # state.u and state.l are views of the stacked sketch [U; L]:
        # count its bytes once.
        mem = {
            "sketch": nbytes(state.sketch),
            "inverted_index": nbytes(state.bits),
            "storage": (sum(t.device_bytes() for t in tiers) if tiers else
                        nbytes(state.store.indices)
                        + nbytes(state.store.values)),
        }
        for component, n in mem.items():
            gauge("repro_engine_bytes", "Measured device bytes by component.",
                  component=component).set(n)
        gauge("repro_engine_dirty_columns",
              "Sketch columns invalidated by delete-recycle (paper §4.3).",
              ).set(int(state.dirty.sum()))

    try:  # analytic §6.1.2 accounting, comparable across capacity changes
        from repro_torch.eval.tune import spec_index_bytes
        gauge("repro_engine_spec_index_bytes",
              "Analytic sketch+inverted-index bytes from the spec.",
              ).set(spec_index_bytes(spec) * n_shards)
    except ImportError:
        pass

    last_lsn = getattr(ix, "_last_lsn", None)
    if last_lsn is not None:
        gauge("repro_wal_last_lsn", "Highest LSN durably applied.").set(last_lsn)
    snap_ts = getattr(ix, "_last_snapshot_ts", None)
    if snap_ts:
        gauge("repro_snapshot_age_s",
              "Seconds since the last completed snapshot.").set(time.time() - snap_ts)
