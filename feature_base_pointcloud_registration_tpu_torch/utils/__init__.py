from .timing import StageTimer, TicToc, trace_profile

__all__ = ["TicToc", "StageTimer", "trace_profile"]
