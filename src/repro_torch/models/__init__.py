"""models subsystem."""
