"""Config dataclass of the 2-D encoder head (a module of its own, as in the
JAX package, so that configs import it without the modules).

Counterpart of ``anytime3d_tpu/nn/heads.py``, field by field."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Head2DConfig:
    output_dim: int
    filter_nums: Tuple[int, ...] = (1024, 1024, 1024, 1024)
    filter_sizes: Tuple[int, ...] = (3, 3, 3, 1)
    last_pooling: Optional[str] = "max"  # 'max' | 'average' | None
    act: str = "elu"
