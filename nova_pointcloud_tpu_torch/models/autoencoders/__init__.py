"""VAE latent distributions of the port; the VAEs themselves wait for t2v."""
