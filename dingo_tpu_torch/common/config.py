"""Flag registry for the port: a copy of dingo_tpu's ``FlagRegistry`` with
only the flags the FLAT, IVF_FLAT, IVF_PQ and HNSW paths read (the pruned
scans, the bf16/sq8 precision tiers, the device graph walk and build
included), those of the coalesced serving path (coalescing window,
tracing, QoS admission and the serving pipeline) and those of the device
recovery ladder, under the JAX package's names and defaults.

Crossovers that JAX resolved against ``jax.default_backend()`` resolve
here against the device the index lives on: "auto" turns the hand-written
kernel on for CUDA tensors at the same thresholds the JAX package uses on
the TPU, and off on the CPU (where the JAX package also runs its XLA arm).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import torch


class Flag:
    def __init__(self, name: str, default: Any, help_: str = "",
                 mutable: bool = False):
        self.name = name
        self.default = default
        self.help = help_
        self.mutable = mutable
        self.value = default


class FlagRegistry:
    """DEFINE_*/FLAGS_* analog with optional hot changes."""

    def __init__(self):
        self._flags: Dict[str, Flag] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, help_: str = "",
               mutable: bool = False) -> None:
        with self._lock:
            if name not in self._flags:
                self._flags[name] = Flag(name, default, help_, mutable)

    def get(self, name: str) -> Any:
        return self._flags[name].value

    def set(self, name: str, value: Any, boot: bool = False) -> None:
        with self._lock:
            flag = self._flags[name]
            if not boot and not flag.mutable:
                raise PermissionError(f"flag {name} is not hot-changeable")
            flag.value = type(flag.default)(value) if flag.default is not None \
                else value

    def all(self) -> Dict[str, Any]:
        return {k: f.value for k, f in self._flags.items()}


FLAGS = FlagRegistry()

FLAGS.define("use_pallas_fused_search", "auto", mutable=True,
             help_="route FLAT L2/IP searches through the fused top-k "
                   "kernel (B1; no [b, n] score matrix). 'auto' enables it "
                   "for CUDA-resident stores with capacity >= 2048; "
                   "True/False force")
FLAGS.define("use_pallas_ivf_search", "auto", mutable=True,
             help_="route trained IVF_FLAT searches through the list-scan "
                   "kernel (B2; reads only probed buckets). 'auto' enables "
                   "it for CUDA-resident indexes with dimension >= 256; "
                   "True/False force")
FLAGS.define("vector_blocked_layout", "auto", mutable=True,
             help_="maintain a dimension-blocked ([n_blocks, capacity, "
                   "block_d]) scan mirror + per-block norms in the slot "
                   "store so FLAT searches can run the pruned kernel (B4). "
                   "'auto' = on for CUDA-resident stores, off on the CPU "
                   "(the mirror costs one more copy of the rows in device "
                   "memory); decided when a store is built; True/False "
                   "force")
FLAGS.define("ivf_prune_scan", "auto", mutable=True,
             help_="use the early-pruning dimension-blocked scan kernels "
                   "(B3 for IVF_FLAT, B4 for FLAT over the blocked mirror) "
                   "wherever the kernel crossover fired and the index has "
                   "blocked metadata. 'auto' = on; False forces the "
                   "non-pruning kernels (B1/B2). An IVF flip takes effect "
                   "at the next view rebuild")
FLAGS.define("ivf_dim_block", 128, mutable=True,
             help_="dimension-block width of the vertical scan layout "
                   "(per-block partial distances let the pruning kernels "
                   "drop candidates that cannot beat the running k-th "
                   "best); an index only builds blocked metadata when its "
                   "dimension is a multiple with >= 2 blocks")
FLAGS.define("ivf_prune_check_interval", 1, mutable=True,
             help_="pruned-scan kernels re-evaluate the partial-distance "
                   "bound every N dimension blocks (1 = every block)")
FLAGS.define("ivf_prune_inbucket_bound", True, mutable=True,
             help_="pruned-scan kernels refresh the k-th-best bound between "
                   "dimension blocks inside a bucket/row block from the "
                   "candidates' own suffix-norm lower bounds, not only "
                   "from shortlist merges")
FLAGS.define("ivf_shape_bucketing", True, mutable=True,
             help_="round (topk, nprobe) up to the {1,1.5}x-pow2 ladder; "
                   "results are sliced back to the requested topk")
FLAGS.define("ivf_compact_tombstone_ratio", 0.25, mutable=True,
             help_="compact an IVF view once this fraction of its rows are "
                   "tombstones")
FLAGS.define("ivf_compact_spill_ratio", 0.5, mutable=True,
             help_="compact once incremental appends allocated this many "
                   "extra spill buckets relative to the dense build")
FLAGS.define("ivfpq_rerank_factor", 8, mutable=True,
             help_="IVF_PQ reranks topk*factor ADC candidates exactly (on "
                   "the device for a device store, from host rows at "
                   "resolve for host_vectors); 1 disables. The fused ADC "
                   "kernel (B5) serves only max(topk*factor, k) <= 64")
FLAGS.define("diskann_rerank_io_rows", 8192, mutable=True,
             help_="DiskANN's exact-rerank disk gathers read at most this "
                   "many (sorted, deduplicated) rows per memmap access: an "
                   "IO budget, so a big batch*k*rerank_factor fan-out "
                   "reads in bounded steps, never one unbounded burst")
FLAGS.define("vector_precision", "fp32", mutable=True,
             help_="default precision tier of float FLAT/IVF_FLAT indexes "
                   "whose parameter leaves precision unset: 'fp32', 'bf16' "
                   "(bf16 rows, f32 accumulation; half the row bytes) or "
                   "'sq8' (uint8 scalar-quantized rows decoded in the scan, "
                   "f32 accumulation; a quarter of the row bytes)")
FLAGS.define("rerank_cache_rows", 0, mutable=True,
             help_="rows of the device exact-rerank cache of each bf16/sq8 "
                   "index (0 = no cache). Cached rows rerank the quantized "
                   "shortlist on the device; uncached candidates keep "
                   "their quantized score")
FLAGS.define("rerank_cache_dtype", "float32", mutable=True,
             help_="dtype of the rerank cache rows: 'float32' (exact) or "
                   "'bfloat16' (half the cache bytes)")
FLAGS.define("quantized_rerank_factor", 4, mutable=True,
             help_="bf16/sq8 searches with a non-empty rerank cache scan "
                   "topk*factor candidates and rerank them exactly on the "
                   "device (1 disables the stage)")
FLAGS.define("train_sample_rows", 65536, mutable=True,
             help_="train-sample row cap for k-means (0 = full corpus, "
                   "lifting derived caps too)")
# -- the region path (engines) ----------------------------------------------
FLAGS.define("lsm_sync_writes", False, mutable=True,
             help_="fsync the native LSM WAL on every commit: power-loss "
                   "durability instead of process-crash durability. Off by "
                   "default: raft replication is the availability story "
                   "and a per-commit fsync costs ~ms (rocksdb's "
                   "WriteOptions.sync analog)")
FLAGS.define("wal_checkpoint_bytes", 64 * 1024 * 1024, mutable=True,
             help_="WalEngine folds the WAL into a checkpoint once it "
                   "exceeds this size, bounding restart replay time")
# -- the coalesced serving path (coalescer, tracer, QoS, pipeline) ----------
FLAGS.define("search_coalescing_window_ms", 0.0, mutable=True,
             help_="merge concurrent same-shaped searches into one device "
                   "batch within this window (0 disables); fills the batch "
                   "dimension instead of spending threads")
FLAGS.define("trace_sampling_rate", 0.0, mutable=True,
             help_="fraction of ingress requests recording a full span "
                   "tree into dingo_tpu_torch/trace (0 disables; 1 records "
                   "everything). Decided once at the trace root; children "
                   "inherit the decision")
FLAGS.define("slow_query_ms", 500.0, mutable=True,
             help_="a sampled root span slower than this lands in the "
                   "slow-query log (retained apart from the span ring so "
                   "fast-trace churn cannot evict slow evidence)")
FLAGS.define("qos_enabled", False, mutable=True,
             help_="deadline-aware serving (obs/pressure.py + the QoS "
                   "coalescer): admission, priority batch forming, expiry "
                   "of dead requests before dispatch and admission shed "
                   "under pressure. Off = observe nothing, act on nothing")
FLAGS.define("qos_default_deadline_ms", 0.0, mutable=True,
             help_="deadline granted to requests arriving without an "
                   "x-dingo-deadline-ms header while qos.enabled (0 = no "
                   "implied deadline)")
FLAGS.define("qos_tenant_header", "x-dingo-tenant", mutable=True,
             help_="metadata key carrying the tenant id for per-tenant "
                   "demand accounting and admission")
FLAGS.define("qos_max_queue_ms", 50.0, mutable=True,
             help_="queue-wait bound the QoS layer defends: admission "
                   "sheds low-priority work once the estimated wait "
                   "exceeds it (priority >= 2 is exempt)")
FLAGS.define("qos_shed_policy", "degrade_drop", mutable=True,
             help_="pressure response: 'off' (observe only), 'degrade' "
                   "(knob ladder only), 'drop' (admission shed only), "
                   "'degrade_drop' (both, default)")
FLAGS.define("qos_tenant_queue_rows", 0, mutable=True,
             help_="per-tenant cap on queued query rows inside the "
                   "coalescer (admission sheds the excess with "
                   "reason=tenant_limit); 0 = unlimited")
# the observability planes (obs/): the JAX package's names and defaults
FLAGS.define("obs_flight_buffer_s", 30.0, mutable=True,
             help_="flight-recorder metrics window: bundles carry metric "
                   "deltas over the last this-many seconds of ticks (the "
                   "store-metrics crontab drives the tick ring)")
FLAGS.define("obs_flight_max_bundles", 16, mutable=True,
             help_="flight-recorder retention: newest N compressed "
                   "bundles kept in memory (0 disables capturing)")
FLAGS.define("obs_exemplars", True, mutable=True,
             help_="attach trace-id exemplars to latency-series outliers "
                   "in the Prometheus exposition (OpenMetrics syntax) so "
                   "a scrape links a bad bucket to its trace/flight "
                   "bundle")
FLAGS.define("hbm_watermark_interval_s", 10.0, mutable=True,
             help_="period of the process device-memory watermark poll (allocator "
                   "bytes-in-use/limit/peak -> hbm.* gauges); per-region "
                   "owner ledgers additionally refresh with every "
                   "store-metrics collection pass")
FLAGS.define("metrics_http_port", 0, mutable=False,
             help_="bind a plain-HTTP sidecar on this port serving "
                   "/metrics (Prometheus text format) and /vars (JSON); "
                   "0 disables")
FLAGS.define("quality_sample_rate", 0.0, mutable=True,
             help_="fraction of live searches re-answered EXACTLY by the "
                   "shadow scan and scored for recall/RBO/score-gap "
                   "(obs/quality.py). Head-sampled like tracing: 0 "
                   "(default) is a zero-alloc noop — no shadow kernels, "
                   "no mirrors, no estimator state; 1 scores every batch "
                   "(benchmarks, tests). Scoring runs on an async lane off the "
                   "request's critical path")
FLAGS.define("quality_slo_recall", 0.95, mutable=True,
             help_="recall@k service-level objective the quality plane "
                   "reports against and the SLO tuner steers toward: the "
                   "tuner tightens knobs while the live estimate's CI "
                   "upper bound sits below this, relaxes when the lower "
                   "bound clears it with margin")
FLAGS.define("quality_window_s", 60.0, mutable=True,
             help_="sliding window of the live quality estimators: "
                   "samples older than this age out of the recall "
                   "estimate/CI (longer = tighter CI, slower reaction)")
FLAGS.define("tuner_enabled", False, mutable=True,
             help_="run the closed-loop SLO parameter controller "
                   "(obs/tuner.py) on the store crontab: one "
                   "cheap-to-expensive ladder step per tick per region, "
                   "driven by the live recall CI vs quality.slo_recall. "
                   "Requires quality.sample_rate > 0 to have a sensor")
FLAGS.define("tuner_interval_s", 30.0, mutable=True,
             help_="period of the quality_tuner crontab (one knob step "
                   "at most per region per tick; the estimator window "
                   "reset after each step is the hysteresis)")
FLAGS.define("tuner_latency_budget_ms", 0.0, mutable=True,
             help_="vector_search p99 budget the tuner respects: it "
                   "never tightens past it, and relaxes while over it "
                   "(if recall allows). 0 = no latency constraint")
FLAGS.define("qos_shed_interval_s", 2.0, mutable=True,
             help_="period of the qos_shed crontab driving the graduated "
                   "degrade ladder (one level per tick each way)")
FLAGS.define("integrity_enabled", True, mutable=True,
             help_="maintain incremental per-artifact state digests "
                   "(obs/integrity.py): every index write folds its batch "
                   "into an order-invariant set digest per artifact (rows, "
                   "sq8 codes, blocked mirror, HNSW adjacency, IVF bucket "
                   "assignment) with O(batch) host work; digests ride "
                   "heartbeats for replica divergence detection and gate "
                   "snapshot restores. Off = no ledgers, no scrub, no "
                   "restore verification")
FLAGS.define("integrity_scrub_interval_s", 60.0, mutable=True,
             help_="period of the consistency_scrub crontab: recompute "
                   "full digests from device state (chunked under "
                   "store.device_lock) and check them against the "
                   "incremental ledger — catches silent HBM/restore "
                   "corruption AND ledger bookkeeping bugs")
FLAGS.define("integrity_flight_on_divergence", True, mutable=True,
             help_="capture a flight-recorder bundle (rate-limited per "
                   "reason) when the scrub finds a corrupted artifact or "
                   "the coordinator sees replicas diverge at equal "
                   "applied indices; the bundle carries the digest "
                   "vectors of both sides")
FLAGS.define("heat_enabled", False, mutable=True,
             help_="workload-heat plane (obs/heat.py): per-region "
                   "exponential-decay access sketches fed from data the "
                   "resolve paths already hold on host (probed IVF "
                   "buckets, FLAT/HNSW result slot ranges) — zero new "
                   "device syncs — plus the derived working-set "
                   "estimator. Off = observe nothing, allocate nothing "
                   "(the quality-plane sampling discipline)")
FLAGS.define("heat_decay_s", 300.0, mutable=True,
             help_="e-folding time constant of the heat sketches: a "
                   "unit untouched for this long keeps 1/e of its mass. "
                   "~5 min tracks traffic shifts faster than the "
                   "coordinator acts on them while riding out "
                   "second-scale burstiness")
FLAGS.define("heat_max_entries", 4096, mutable=True,
             help_="bound on live sketch entries per region: past it the "
                   "coldest units are evicted (their mass is the least "
                   "informative). Memory per region stays O(max_entries)")
FLAGS.define("cost_enabled", True, mutable=True,
             help_="per-(kernel, padded-shape-ladder-point) dispatch "
                   "cost model (obs/cost.py) learned from the completion "
                   "lane's stage timings; consulted by QoS "
                   "estimated_wait_ms and the SLO tuner's latency "
                   "budget. Off = the coalescer falls back to its single "
                   "scalar per-row EWMA")
FLAGS.define("cost_prior_row_ms", 0.5, mutable=True,
             help_="conservative per-row service-time prior the wait "
                   "estimator sheds on before the first measured sample "
                   "lands — the first overload burst must not ride in on "
                   "a 0ms estimate (pessimistic on purpose: over-shedding "
                   "a cold store beats serving it into collapse)")
FLAGS.define("events_enabled", True, mutable=True,
             help_="control-plane flight recorder (obs/events.py): every "
                   "controller actuation — tuner step, shed ladder move, "
                   "tier transition, recovery rung, replica scale, "
                   "capacity advisory, cache stale rung — records a "
                   "structured event with the evidence it decided on. "
                   "Events ride heartbeats to the coordinator for the "
                   "cluster timeline and `cluster explain`. Off = emit "
                   "is one flag read, nothing is allocated or shipped")
FLAGS.define("events_max_entries", 1024, mutable=True,
             help_="bound on the per-node event ring AND the "
                   "coordinator's merged timeline: past it the oldest "
                   "events fall off (never-shipped ones count into "
                   "event.dropped). Controller decisions are crontab-"
                   "paced, so 1024 covers hours of history")
FLAGS.define("events_heartbeat_batch", 128, mutable=True,
             help_="max events one heartbeat carries to the coordinator "
                   "(each ships exactly once — the collector keeps a "
                   "harvest cursor). 0 keeps the ledger node-local "
                   "(EventDump/flight bundles still see it)")
FLAGS.define("pipeline_enabled", "auto", mutable=True,
             help_="overlapped serving pipeline: the coalescer's flush "
                   "thread dispatches every due batch's kernels before any "
                   "resolve runs, resolves drain on a completion lane, and "
                   "query staging reuses pinned host slots. 'auto' = on "
                   "for a CUDA device, off on the CPU; True/False force")
FLAGS.define("pipeline_depth", 2, mutable=True,
             help_="staging-ring depth per coalescer key: batch N+1's query "
                   "upload can overlap batch N's compute up to this many "
                   "batches in flight (1 = no overlap, 2 = double "
                   "buffering)")
FLAGS.define("cache_enabled", False, mutable=True,
             help_="serving-edge result cache + in-flight query dedupe "
                   "(dingo_tpu_torch/cache/): identical query rows inside "
                   "one coalescer flush collapse to a single kernel row, "
                   "and exact repeats of plain searches are answered from "
                   "a bounded per-region result cache keyed on (query "
                   "fingerprint, SlotStore.mutation_version, resolved "
                   "params): a hit costs no queue slot and launches no "
                   "kernel")
FLAGS.define("cache_max_bytes", 64 * 1024 * 1024, mutable=True,
             help_="LRU bound on the result cache's host memory across all "
                   "regions (approximate accounting: cached rows are (id, "
                   "distance) pairs). 0 disables caching while leaving "
                   "in-flight dedupe active")
FLAGS.define("cache_stale_versions", 1, mutable=True,
             help_="serve-slightly-stale degrade rung: while a region's "
                   "shed ladder is degraded (qos.degrade_level > 0) a "
                   "lookup may fall back to entries at most this many "
                   "mutation_versions behind the live store. 0 = exact "
                   "version only, always")
FLAGS.define("cache_semantic", False, mutable=True,
             help_="semantic (approximate) cache hits via sq8-quantized "
                   "query fingerprints: near-identical queries that "
                   "quantize to the same codes share an entry. Gated live "
                   "by the shadow-quality estimator: approximate hits "
                   "serve only while the windowed recall CI lower bound "
                   "holds quality_slo_recall")
FLAGS.define("cache_tenant_share", 0.5, mutable=True,
             help_="per-tenant fairness bound: the fraction of "
                   "cache_max_bytes any single tenant's entries may occupy "
                   "(its own inserts evict its own LRU tail past the "
                   "share). <= 0 or >= 1 disables the bound")
FLAGS.define("tier_enabled", False, mutable=True,
             help_="memory-tier ladder (index/tiering.py): a store-local "
                   "policy loop demotes cold regions along device fp32/bf16 "
                   "-> device sq8 -> host-RAM sq8 -> mmap'd sq8 codes and "
                   "promotes them back on re-warm, every transition "
                   "digest-gated against the state-integrity ledger. "
                   "Inputs: capacity demote advisories, heat working-set "
                   "bytes against device headroom, windowed search QPS. "
                   "Off = regions stay at their declared tier")
FLAGS.define("tier_demote_headroom", 0.15, mutable=True,
             help_="free device-memory fraction below which the tier loop "
                   "demotes the coldest resident region one rung")
FLAGS.define("tier_promote_qps", 5.0, mutable=True,
             help_="sustained windowed vector-search QPS above which a "
                   "demoted region promotes one rung back toward its "
                   "declared tier (given device headroom to fit it)")
FLAGS.define("tier_mmap_dir", "", mutable=True,
             help_="directory for the mmap rung's code files (one "
                   "region_<id>.codes per demoted region); empty = a "
                   "per-process temp directory")
FLAGS.define("tier_interval_s", 30.0, mutable=True,
             help_="tier policy tick cadence (store crontab): each tick "
                   "applies at most one transition per store")

FLAGS.define("hnsw_device_search", "auto", mutable=True,
             help_="route HNSW searches through the device graph tier: "
                   "the lockstep beam walk over the level-0 adjacency "
                   "mirror (ops/beam.py) and an exact device rerank of "
                   "its beam. 'auto' = on for a CUDA-resident store, off "
                   "on the CPU (the host C++ graph stays the CPU arm and "
                   "the parity oracle). True/False force")
FLAGS.define("hnsw_device_beam", 0, mutable=True,
             help_="fixed candidate-beam width of the device HNSW walk; 0 "
                   "derives it from the request ef by the {1,1.5}x-pow2 "
                   "shape-bucket ladder")
FLAGS.define("hnsw_max_iters", 48, mutable=True,
             help_="expansion rounds of the device HNSW walk (one round "
                   "expands every beam entry one hop); a query stops "
                   "changing once its beam converges")
FLAGS.define("hnsw_device_build", "auto", mutable=True,
             help_="build bulk HNSW graphs on the device "
                   "(ops/graph_build.py) in pow2 insert batches; the "
                   "native graph back-fills on first host-path use. "
                   "'auto' = on for a CUDA-resident store, off on the "
                   "CPU. True/False force")
FLAGS.define("hnsw_build_batch", 256, mutable=True,
             help_="rows per device bulk-build insert batch (rounded up "
                   "to a power of two; the last batch pads with dropped "
                   "lanes)")
FLAGS.define("hnsw_build_alpha", 1.0, mutable=True,
             help_="occlusion-pruning factor of the device bulk build "
                   "(DiskANN's alpha): a candidate is pruned once it "
                   "scores closer to a kept neighbour than to the inserted "
                   "point, the kept score scaled by alpha^2")
FLAGS.define("device_recovery_enabled", True, mutable=True,
             help_="graduated device OOM recovery ladder "
                   "(index/recovery.py): on an OOM during a device write "
                   "or search, drop rerank caches, evict the blocked and "
                   "adjacency mirrors, retry once; if it fails again, "
                   "mark the region device-degraded (served by the host "
                   "exact path) until re-materialization. Off = OOMs "
                   "propagate")
FLAGS.define("device_recovery_remat_precision", "sq8", mutable=True,
             help_="precision tier a device-degraded region is "
                   "re-materialized at (the region definition keeps its "
                   "declared precision)")

# the control plane: heartbeats, the split checker, the metrics collector,
# the balance/replica planners, the capacity plane and the view-compaction
# crontab (the JAX package's names and defaults)
FLAGS.define("server_heartbeat_interval_s", 10, mutable=True)
FLAGS.define("region_max_size_bytes", 256 * 1024 * 1024, mutable=True)
FLAGS.define("split_check_approximate_keys", 1_000_000, mutable=True)
FLAGS.define("metrics_collect_interval_s", 5.0, mutable=True,
             help_="StoreMetricsCollector crontab period; heartbeats also "
                   "refresh snapshots older than this so beats never ship "
                   "stale figures even without the crontab")
FLAGS.define("balance_mode", "count", mutable=True,
             help_="leader balancing signal: 'count' (leader tallies) or "
                   "'load' (measured per-region QPS + memory bytes from "
                   "store metrics; falls back to count while metrics are "
                   "missing or stale)")
FLAGS.define("balance_replica_mode", "off", mutable=True,
             help_="coordinator replica planning: 'off' or 'auto' (scale "
                   "a region's read-replica count from its measured QPS "
                   "via the store-metrics plane; placement picks the "
                   "least-loaded stores)")
FLAGS.define("balance_replica_qps_target", 50.0, mutable=True,
             help_="replica planning aims for at most this many QPS per "
                   "replica before adding another (auto mode)")
FLAGS.define("capacity_advise", True, mutable=True,
             help_="coordinator capacity plane: roll per-store device "
                   "headroom vs heartbeat working-set demand and emit "
                   "advisory tier/split recommendations (capacity.* "
                   "metrics); never actuates")
FLAGS.define("capacity_headroom_target", 0.2, mutable=True,
             help_="fraction of a store's device memory the capacity plane "
                   "wants free: below it the coldest region (most resident "
                   "bytes outside its working set) draws a demote "
                   "advisory")
FLAGS.define("ivf_compact_interval_s", 60.0, mutable=True,
             help_="period of the IVF view-compaction crontab: restores "
                   "the dense bucket layout (full rebuild) off the search "
                   "path once tombstone/spill garbage accumulates")


def _parse_tri(flag) -> Optional[bool]:
    """Tri-state crossover flag: None = 'auto', True/False force. FLAGS.set
    coerces to the default's type, so booleans may arrive as strings."""
    if isinstance(flag, str):
        low = flag.strip().lower()
        if low == "auto":
            return None
        return low in ("true", "1", "on", "yes")
    return bool(flag)


def fused_kernel_enabled(capacity: int, device: torch.device) -> bool:
    """use_pallas_fused_search crossover for FLAT searches."""
    v = _parse_tri(FLAGS.get("use_pallas_fused_search"))
    if v is None:
        return device.type == "cuda" and capacity >= 2048
    return v


def ivf_kernel_enabled(dimension: int, device: torch.device) -> bool:
    """use_pallas_ivf_search crossover for trained IVF_FLAT and IVF_PQ
    searches (kernels B2/B3 and B5)."""
    v = _parse_tri(FLAGS.get("use_pallas_ivf_search"))
    if v is None:
        return device.type == "cuda" and dimension >= 256
    return v


def prune_scan_enabled() -> bool:
    """Tri-state ivf_prune_scan: 'auto' = on (the pruned kernels are only
    reachable where the kernel crossover already fired and the index has
    blocked metadata, so there is no separate device condition)."""
    v = _parse_tri(FLAGS.get("ivf_prune_scan"))
    return True if v is None else v


def blocked_layout_enabled(device: torch.device) -> bool:
    """Tri-state vector_blocked_layout: 'auto' keeps the blocked FLAT scan
    mirror on CUDA-resident stores only (it duplicates the rows in device
    memory; on the CPU no crossover routes to the kernel that reads it
    unless forced, as in the JAX package off the TPU)."""
    v = _parse_tri(FLAGS.get("vector_blocked_layout"))
    if v is None:
        return torch.device(device).type == "cuda"
    return v


def train_sample_rows() -> int:
    """Row cap shared by the train paths (floor 0; 0 = full corpus)."""
    try:
        return max(0, int(FLAGS.get("train_sample_rows")))
    except (TypeError, ValueError):
        return 65536


def serving_pipeline_enabled(device: torch.device) -> bool:
    """Tri-state pipeline_enabled for a coalescer serving `device`. The
    JAX package's 'auto' means "on the accelerator only", because CPU XLA
    runs synchronously inside dispatch. Here 'auto' is on for a CUDA
    device (kernel launches return before the card finishes, so the
    completion lane overlaps a fetch with the next dispatch) and off on
    the CPU, where the plain versions run inside dispatch and the lane's
    thread hop would only add latency. True/False force."""
    v = _parse_tri(FLAGS.get("pipeline_enabled"))
    if v is None:
        return torch.device(device).type == "cuda"
    return v


def pipeline_depth() -> int:
    """Staging-ring depth for the serving pipeline (floor 1)."""
    try:
        return max(1, int(FLAGS.get("pipeline_depth")))
    except (TypeError, ValueError):
        return 2


def result_cache_enabled() -> bool:
    """Whole-subsystem gate for the serving-edge cache (dedupe + result
    cache): one flag read."""
    v = FLAGS.get("cache_enabled")
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "on", "yes")
    return bool(v)


def hnsw_device_enabled(device: torch.device) -> bool:
    """Tri-state hnsw_device_search for an index on `device`: 'auto' walks
    the graph on the card for a CUDA-resident store and on the host C++
    graph on the CPU (the JAX package's 'auto' is TPU-only)."""
    v = _parse_tri(FLAGS.get("hnsw_device_search"))
    if v is None:
        return torch.device(device).type == "cuda"
    return v


def hnsw_device_build_enabled(device: torch.device) -> bool:
    """Tri-state hnsw_device_build for an index on `device`, read like
    hnsw_device_enabled."""
    v = _parse_tri(FLAGS.get("hnsw_device_build"))
    if v is None:
        return torch.device(device).type == "cuda"
    return v
