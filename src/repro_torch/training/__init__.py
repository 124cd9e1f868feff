"""training subsystem."""
