"""Synthetic corpus and query streams (numpy; same seeds as `repro.data`)."""
