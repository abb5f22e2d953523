"""Autoregressive models: PixelCNN."""
