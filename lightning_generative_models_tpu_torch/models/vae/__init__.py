"""VQ-VAE family."""
