"""Stdlib serving telemetry."""
