"""Experiment directories, logging and meters."""
