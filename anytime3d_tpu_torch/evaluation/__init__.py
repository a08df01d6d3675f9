"""Evaluation protocols: missing-rate sweeps, PR curves, per-class latents, reconstruction dumps."""
