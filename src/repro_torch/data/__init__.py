"""data subsystem."""
