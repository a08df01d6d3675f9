"""Procedural loaders, bit-packed voxel transfer and the batch prefetcher."""
