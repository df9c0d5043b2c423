"""Host utilities: logging and runtime gauges."""
