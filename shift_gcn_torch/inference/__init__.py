"""Offline fall-detection pipeline over landmark sequences."""
