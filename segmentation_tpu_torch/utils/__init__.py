"""Checkpoint reading, and the spans and counters of the port (trace)."""
