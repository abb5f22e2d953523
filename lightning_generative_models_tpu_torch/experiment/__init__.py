"""Experiment artefacts."""
