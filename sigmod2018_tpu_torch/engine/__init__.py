from .executor import (HARD_INTERMEDIATE_CAP, Component, IntermediateBlowup,
                       NullResult, PendingResult, TorchEngine, format_batch)

__all__ = [
    "HARD_INTERMEDIATE_CAP",
    "Component",
    "IntermediateBlowup",
    "NullResult",
    "PendingResult",
    "TorchEngine",
    "format_batch",
]
