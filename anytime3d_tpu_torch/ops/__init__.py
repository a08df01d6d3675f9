"""Losses, metrics and latent sampling."""
