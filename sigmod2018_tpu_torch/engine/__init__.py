from .executor import (HARD_INTERMEDIATE_CAP, TIERS, Component,
                       IntermediateBlowup, NullResult, PendingResult,
                       TorchEngine, format_batch)

__all__ = [
    "HARD_INTERMEDIATE_CAP",
    "TIERS",
    "Component",
    "IntermediateBlowup",
    "NullResult",
    "PendingResult",
    "TorchEngine",
    "format_batch",
]
