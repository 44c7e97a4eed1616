# Execution plans (device-resident epoch stacks + the per-batch reference
# loop), the phase-program driver and the project-once activation store.
from repro_torch.runtime.activations import ActivationStore, store_for
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

__all__ = [
    "ActivationStore", "store_for",
    "forward_stack", "gather_batch", "rows_to", "hidden_epoch_cached_fn", "hidden_epoch_fn",
    "readout_epoch_cached_fn", "readout_epoch_fn", "sgd_epoch_cached_fn", "sgd_epoch_fn",
    "sgd_step", "stack_epoch",
    "BatchPlan", "ExecutionPlan", "ScanPlan", "make_plan",
    "BcpnnReadoutPhase", "HiddenPhase", "ProgramResult", "SgdReadoutPhase", "TrainProgram",
    "compile_program", "run_program",
]
