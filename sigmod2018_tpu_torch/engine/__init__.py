"""The engines.  The exports load their module on first access, so that
`engine.oracle` and `engine.factorized`'s host half import without torch
(io/repl.py answers its warm-up tier with them while torch imports)."""

import importlib

_EXPORTS = {
    "CompiledTorchEngine": "compiled",
    "SpecResult": "compiled",
    "HARD_INTERMEDIATE_CAP": "executor",
    "TIERS": "executor",
    "Component": "executor",
    "IntermediateBlowup": "executor",
    "NullResult": "executor",
    "PendingResult": "executor",
    "TorchEngine": "executor",
    "format_batch": "executor",
    "execute_query_numpy": "oracle",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{module}", __name__), name)
