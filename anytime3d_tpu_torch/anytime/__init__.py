"""The anytime protocol: nearest-prior classification, prior correction, Gaussian and occupancy fusion
(sequential and split over the ranks of a mesh), and the streaming ``AnytimeReconstructor``."""

from anytime3d_tpu_torch.anytime.engine import (
    GaussianBelief,
    OccupancyBelief,
    anytime_eval,
    classify_by_prior,
    correct_latent,
    fuse_observation,
    fuse_occupancy,
    fuse_sequence,
    fuse_sequence_sharded,
)
from anytime3d_tpu_torch.anytime.reconstructor import AnytimeReconstructor

__all__ = [
    "AnytimeReconstructor",
    "GaussianBelief",
    "OccupancyBelief",
    "anytime_eval",
    "classify_by_prior",
    "correct_latent",
    "fuse_observation",
    "fuse_occupancy",
    "fuse_sequence",
    "fuse_sequence_sharded",
]
