"""Configuration and profiling."""
