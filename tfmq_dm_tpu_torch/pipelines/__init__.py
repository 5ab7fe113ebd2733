"""Checkpoint loading, calibration-data generation and sampling loops."""
