"""Autoencoders: the denoising MLP autoencoder and the UNet autoencoder."""
