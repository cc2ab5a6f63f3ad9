"""Observability of the port — ``tpu_rl.obs``'s single-process plane:
metrics registries, the telemetry aggregator, exporters (Prometheus / JSON
/ tensorboard), the live performance plane (FLOPs/MFU/recompiles/device
memory + profiler capture), the SLO engine, the goodput ledger, the
learning-dynamics plane (``tpu_rl_torch.obs.learn``) and the run-history
plane (time-series store + ``/query`` + anomaly detection), and the fleet's
span tracing, clock sync and trace merge that the distributed runtime's
roles use.
"""

from tpu_rl_torch.obs.aggregator import (
    DEFAULT_STALE_AFTER_S,
    LEARNER_VERSION_GAUGE,
    STALENESS_HIST,
    TelemetryAggregator,
    maybe_aggregator,
)
from tpu_rl_torch.obs.anomaly import (
    ANOMALY_LEVEL_SHIFTS_METRIC,
    ANOMALY_SPIKES_METRIC,
    AnomalyDetector,
)
from tpu_rl_torch.obs.audit import append_jsonl, append_resume
from tpu_rl_torch.obs.clocksync import ClockEstimate, ClockSync
from tpu_rl_torch.obs.exporters import (
    JsonExporter,
    TelemetryHTTPServer,
    TensorboardExporter,
    render_healthz,
    render_prometheus,
)
from tpu_rl_torch.obs.flightrec import FlightRecorder
from tpu_rl_torch.obs.goodput import (
    BUCKETS,
    STRAGGLER_GAUGE,
    GoodputLedger,
    maybe_ledger,
    robust_z,
    straggler_report,
)
from tpu_rl_torch.obs.history import (
    HistoryReader,
    TimeSeriesStore,
    channel_name,
    downsample,
    flatten_snapshots,
    history_path,
    maybe_history,
)
from tpu_rl_torch.obs.learn import (
    BUCKET_GAUGE_PREFIX,
    GAUGE_PREFIX,
    N_STALE_BUCKETS,
    STALE_BUCKET_LABELS,
    DiagAccumulator,
    derive,
    ess_normalized,
    explained_variance,
    host_stale_rows,
    learn_record,
    publish,
    stale_bucket_index,
)
from tpu_rl_torch.obs.merge import merge_result_dir, merge_traces
from tpu_rl_torch.obs.perf import (
    PEAK_FLOPS,
    PerfTracker,
    ProfilerCapture,
    device_memory_bytes,
    device_peak_flops,
    process_self_stats,
)
from tpu_rl_torch.obs.registry import (
    HIST_BUCKETS,
    MetricsRegistry,
    PeriodicSnapshot,
    diff_snapshots,
    hist_quantile,
    merge_snapshots,
)
from tpu_rl_torch.obs.slo import SloEngine, SloRule, maybe_slo_engine, parse_slo_spec
from tpu_rl_torch.obs.trace import TraceRecorder

__all__ = [
    "ANOMALY_LEVEL_SHIFTS_METRIC",
    "ANOMALY_SPIKES_METRIC",
    "AnomalyDetector",
    "BUCKETS",
    "BUCKET_GAUGE_PREFIX",
    "ClockEstimate",
    "ClockSync",
    "DEFAULT_STALE_AFTER_S",
    "DiagAccumulator",
    "FlightRecorder",
    "GAUGE_PREFIX",
    "GoodputLedger",
    "HIST_BUCKETS",
    "HistoryReader",
    "JsonExporter",
    "LEARNER_VERSION_GAUGE",
    "MetricsRegistry",
    "N_STALE_BUCKETS",
    "PEAK_FLOPS",
    "PerfTracker",
    "PeriodicSnapshot",
    "ProfilerCapture",
    "STALENESS_HIST",
    "STALE_BUCKET_LABELS",
    "STRAGGLER_GAUGE",
    "SloEngine",
    "SloRule",
    "TelemetryAggregator",
    "TelemetryHTTPServer",
    "TensorboardExporter",
    "TimeSeriesStore",
    "TraceRecorder",
    "append_jsonl",
    "append_resume",
    "channel_name",
    "derive",
    "device_memory_bytes",
    "device_peak_flops",
    "diff_snapshots",
    "downsample",
    "ess_normalized",
    "explained_variance",
    "flatten_snapshots",
    "hist_quantile",
    "history_path",
    "host_stale_rows",
    "learn_record",
    "maybe_aggregator",
    "maybe_history",
    "maybe_ledger",
    "maybe_slo_engine",
    "merge_result_dir",
    "merge_snapshots",
    "merge_traces",
    "parse_slo_spec",
    "process_self_stats",
    "publish",
    "render_healthz",
    "render_prometheus",
    "robust_z",
    "stale_bucket_index",
    "straggler_report",
]
