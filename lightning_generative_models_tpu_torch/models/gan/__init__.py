"""GAN family."""
