# The hot-path guard: the static side (torchlint, pure stdlib, so it runs
# without torch) is re-exported eagerly; the runtime side (strict-mode
# verification) imports torch, so it loads lazily via __getattr__ to keep
# `import repro_torch.analysis` torch-free.
from repro_torch.analysis.lint import (
    DEFAULT_HOT_MODULES,
    RULES,
    Finding,
    lint_paths,
    lint_source,
)

_STRICT_EXPORTS = (
    "StrictViolation",
    "HostTransferError",
    "RecompileError",
    "NonFiniteError",
    "Counted",
    "counted",
    "RecompileSentinel",
    "dispatch_guard",
    "finite_checker",
)


def __getattr__(name):
    if name in _STRICT_EXPORTS:
        from repro_torch.analysis import strict

        return getattr(strict, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DEFAULT_HOT_MODULES",
    "RULES",
    "Finding",
    "lint_paths",
    "lint_source",
    *_STRICT_EXPORTS,
]
