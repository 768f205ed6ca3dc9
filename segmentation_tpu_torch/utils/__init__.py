"""Checkpoint reading."""
