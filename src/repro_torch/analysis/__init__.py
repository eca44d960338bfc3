"""Roofline terms of a traced dry-run step, and the dry-run, roofline
and trace tables."""

from .roofline import RooflineReport, StepCounter, analyze_counts

__all__ = ["RooflineReport", "StepCounter", "analyze_counts"]
