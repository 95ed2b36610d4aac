from .trajectory import (
    AnalysisContext,
    AnalysisTask,
    TrajectoryReader,
    WindowAnalysisTask,
    WindowPipeline,
)

__all__ = [
    "AnalysisContext",
    "AnalysisTask",
    "TrajectoryReader",
    "WindowAnalysisTask",
    "WindowPipeline",
]
