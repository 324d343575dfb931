"""Image post-processing."""

from __future__ import annotations

import numpy as np
import torch


def postprocess_images(decoded: torch.Tensor) -> np.ndarray:
    """VAE output (b, 3, H, W) in [-1, 1] -> uint8 (b, H, W, 3): x/2 + 0.5,
    clamp, round half to even, as ``tpdm_tpu/utils/image.py``."""
    x = torch.clamp(decoded.float() / 2.0 + 0.5, 0.0, 1.0)
    x = torch.round(x * 255.0).to(torch.uint8)
    return x.permute(0, 2, 3, 1).cpu().numpy()
