"""Image files to 8-bit BGR arrays, as the JAX loaders read them."""

from __future__ import annotations

from typing import Optional

import numpy as np


def imread_color(path) -> Optional[np.ndarray]:
    """``cv2.imread(path, cv2.IMREAD_COLOR)``: (H, W, 3) uint8 BGR, or None for
    a file that is missing or cannot be decoded. ``cv2`` is imported here, on
    the first read, so that the modules that only import the loaders do not
    need it; where it does not import, this raises ``ImportError``."""
    import cv2

    return cv2.imread(str(path), cv2.IMREAD_COLOR)
