from .serve_loop import ServeLoop, ServeStats, SessionRegistry
from .straggler import StragglerConfig, StragglerDetector
from .train_loop import (TrainLoopConfig, TrainResult, TransientFailure,
                         run_training)

__all__ = ["ServeLoop", "ServeStats", "SessionRegistry", "StragglerConfig",
           "StragglerDetector", "TrainLoopConfig", "TrainResult",
           "TransientFailure", "run_training"]
