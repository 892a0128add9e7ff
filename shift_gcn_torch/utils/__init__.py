"""Checkpoint carry-over and device helpers."""
