from .serve_loop import ServeLoop, ServeStats, SessionRegistry

__all__ = ["ServeLoop", "ServeStats", "SessionRegistry"]
