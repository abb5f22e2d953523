"""Normalizing flows: NICE and Glow."""
