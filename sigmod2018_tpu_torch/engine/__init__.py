from .compiled import CompiledTorchEngine, SpecResult
from .executor import (HARD_INTERMEDIATE_CAP, TIERS, Component,
                       IntermediateBlowup, NullResult, PendingResult,
                       TorchEngine, format_batch)

__all__ = [
    "CompiledTorchEngine",
    "HARD_INTERMEDIATE_CAP",
    "SpecResult",
    "TIERS",
    "Component",
    "IntermediateBlowup",
    "NullResult",
    "PendingResult",
    "TorchEngine",
    "format_batch",
]
