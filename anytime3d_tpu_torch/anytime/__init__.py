"""The anytime protocol: nearest-prior classification, prior correction, Gaussian and occupancy fusion,
and the streaming ``AnytimeReconstructor``."""

from anytime3d_tpu_torch.anytime.reconstructor import AnytimeReconstructor

__all__ = ["AnytimeReconstructor"]
