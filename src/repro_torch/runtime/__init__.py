# Execution plans (device-resident epoch stacks + the per-batch reference
# loop), the phase-program runner and the project-once activation store,
# and the serving subsystem (ServiceConfig -> InferenceService -> ServePlan:
# batched / streaming) with the async engine, latency telemetry, request
# tracing and OpenMetrics export.  The reference's router (and its metrics),
# continual tier (and its drift window and journal events), decode plan and
# training loop wait for later slices.
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
from repro_torch.runtime.metrics import Counter, Gauge, Histogram, ServiceMetrics
from repro_torch.runtime.plans import BatchPlan, ExecutionPlan, ScanPlan, make_plan
from repro_torch.runtime.program import (
    BcpnnReadoutPhase,
    HiddenPhase,
    ProgramResult,
    SgdReadoutPhase,
    TrainProgram,
    compile_program,
    run_program,
)
from repro_torch.runtime.service import (
    SERVE_PLANS,
    BatchedPlan,
    InferenceService,
    ServePlan,
    ServiceConfig,
    StreamingPlan,
)
from repro_torch.runtime.trace import EventJournal, SpanRecord, TraceConfig, Tracer, build_tracer
from repro_torch.runtime.export import (
    MetricsServer,
    OpenMetricsError,
    parse_openmetrics,
    render_openmetrics,
)

__all__ = [
    "ActivationStore", "store_for",
    "forward_stack", "gather_batch", "rows_to", "hidden_epoch_cached_fn", "hidden_epoch_fn",
    "readout_epoch_cached_fn", "readout_epoch_fn", "sgd_epoch_cached_fn", "sgd_epoch_fn",
    "sgd_step", "stack_epoch",
    "BatchPlan", "ExecutionPlan", "ScanPlan", "make_plan",
    "BcpnnReadoutPhase", "HiddenPhase", "ProgramResult", "SgdReadoutPhase", "TrainProgram",
    "compile_program", "run_program",
    "AsyncEngine", "EngineStopped", "QueueFull",
    "Counter", "Gauge", "Histogram", "ServiceMetrics",
    "SERVE_PLANS", "BatchedPlan", "InferenceService", "ServePlan", "ServiceConfig",
    "StreamingPlan",
    "TraceConfig", "Tracer", "build_tracer", "SpanRecord", "EventJournal",
    "MetricsServer", "OpenMetricsError", "parse_openmetrics",
    "render_openmetrics",
]
