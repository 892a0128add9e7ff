"""Single-process training: config, optimizer, steps and the Trainer."""
