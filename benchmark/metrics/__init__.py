"""Per-layer metrics: ``<name>.py`` reads one metric from a run's
context (spans, the Trainer's timers, the profiled sub-window) and
returns a number, or None when it finds nothing to read."""
