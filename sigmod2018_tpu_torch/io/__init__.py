from .repl import main, run_protocol

__all__ = ["main", "run_protocol"]
