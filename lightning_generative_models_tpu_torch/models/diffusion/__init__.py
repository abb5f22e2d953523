"""Diffusion models."""
