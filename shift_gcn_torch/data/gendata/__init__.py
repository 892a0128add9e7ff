"""Pose extraction from video (the serving half of dataset generation)."""
