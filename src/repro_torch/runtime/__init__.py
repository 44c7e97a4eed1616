# Execution plans (device-resident epoch stacks + the per-batch reference
# loop), the phase-program runner and the project-once activation store,
# and the serving subsystem (ServiceConfig -> InferenceService -> ServePlan:
# batched / decode / streaming / continual, serve_model / serve_fleet for
# the LM zoo) with the async engine, latency telemetry, request tracing and
# OpenMetrics export, the Router serving fabric (per-tenant SLO scheduling
# over N engines), and the continual-learning tier (online Hebbian updates
# under live traffic with per-tenant adapters, drift detection, and
# snapshot/rollback), and the LM zoo's fault-tolerant training loop.
from repro_torch.runtime.activations import ActivationStore, store_for
from repro_torch.runtime.engine import AsyncEngine, EngineStopped, QueueFull
from repro_torch.runtime.epoch_engine import (
    forward_stack,
    gather_batch,
    rows_to,
    hidden_epoch_cached_fn,
    hidden_epoch_fn,
    readout_epoch_cached_fn,
    readout_epoch_fn,
    sgd_epoch_cached_fn,
    sgd_epoch_fn,
    sgd_step,
    stack_epoch,
)
from repro_torch.runtime.metrics import (
    Counter,
    DriftWindow,
    Gauge,
    Histogram,
    RouterMetrics,
    ServiceMetrics,
    TenantMetrics,
    format_latency_line,
)
from repro_torch.runtime.plans import BatchPlan, ExecutionPlan, ScanPlan, make_plan
from repro_torch.runtime.program import (
    BcpnnReadoutPhase,
    HiddenPhase,
    ProgramResult,
    SgdReadoutPhase,
    TrainProgram,
    check_finite,
    compile_program,
    run_program,
)
from repro_torch.runtime.service import (
    SERVE_PLANS,
    BatchedPlan,
    Completion,
    DecodePlan,
    DecodeSession,
    InferenceService,
    Request,
    ServePlan,
    ServiceConfig,
    StreamingPlan,
    pad_cache_like,
    serve_fleet,
    serve_model,
)
from repro_torch.runtime.trace import (
    DeadlineShed,
    EngineRestart,
    EventJournal,
    MergeApplied,
    RecompileRebaseline,
    RollbackApplied,
    SpanRecord,
    TenantShed,
    TraceConfig,
    Tracer,
    build_tracer,
)
from repro_torch.runtime.export import (
    MetricsServer,
    OpenMetricsError,
    parse_openmetrics,
    render_openmetrics,
)
from repro_torch.runtime.continual import (
    MERGE_STRATEGIES,
    ContinualConfig,
    ContinualPlan,
    DriftDetected,
    Feedback,
)
from repro_torch.runtime.train_loop import TrainLoopConfig, TrainLoopResult, train_loop
from repro_torch.runtime.serve_loop import ServeSession
from repro_torch.runtime.router import (
    DeadlineExceeded,
    NoEngineAvailable,
    Router,
    RouterConfig,
    RouterError,
    RouterStopped,
    TenantConfig,
    TenantQueueFull,
)

__all__ = [
    "ActivationStore", "store_for",
    "forward_stack", "gather_batch", "rows_to", "hidden_epoch_cached_fn", "hidden_epoch_fn",
    "readout_epoch_cached_fn", "readout_epoch_fn", "sgd_epoch_cached_fn", "sgd_epoch_fn",
    "sgd_step", "stack_epoch",
    "BatchPlan", "ExecutionPlan", "ScanPlan", "make_plan",
    "BcpnnReadoutPhase", "HiddenPhase", "ProgramResult", "SgdReadoutPhase", "TrainProgram",
    "check_finite", "compile_program", "run_program",
    "AsyncEngine", "EngineStopped", "QueueFull",
    "ContinualConfig", "ContinualPlan", "DriftDetected", "Feedback",
    "MERGE_STRATEGIES",
    "Counter", "DriftWindow", "Gauge", "Histogram", "ServiceMetrics",
    "TenantMetrics", "RouterMetrics", "format_latency_line",
    "Router", "RouterConfig", "RouterError", "RouterStopped", "TenantConfig",
    "TenantQueueFull", "DeadlineExceeded", "NoEngineAvailable",
    "SERVE_PLANS", "BatchedPlan", "InferenceService", "ServePlan", "ServiceConfig",
    "StreamingPlan", "DecodePlan", "DecodeSession", "Request", "Completion",
    "pad_cache_like", "serve_model", "serve_fleet", "ServeSession",
    "TrainLoopConfig", "TrainLoopResult", "train_loop",
    # The trace module's DriftDetected *event* is not re-exported: the
    # continual tier's exception keeps that name here.
    "TraceConfig", "Tracer", "build_tracer", "SpanRecord", "EventJournal",
    "EngineRestart", "MergeApplied", "RollbackApplied", "RecompileRebaseline",
    "DeadlineShed", "TenantShed",
    "MetricsServer", "OpenMetricsError", "parse_openmetrics",
    "render_openmetrics",
]
