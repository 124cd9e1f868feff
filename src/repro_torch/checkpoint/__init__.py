"""checkpoint subsystem."""
