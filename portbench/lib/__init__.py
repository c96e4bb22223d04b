"""Shared arithmetic of the harness: statistics, trace reduction, work
formulas and peaks, seeds."""
