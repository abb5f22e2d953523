"""Layers and blocks shared by the models."""
