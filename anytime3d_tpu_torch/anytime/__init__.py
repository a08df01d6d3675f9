"""The anytime protocol: nearest-prior classification, prior correction, Gaussian and occupancy fusion."""
