"""Training batches (counterpart of hdenseunet_tpu/data/sampler.py).

Only :func:`synthetic_batches` is ported; the guided ``CropSampler`` over
preprocessed LiTS volumes comes with the data-feed slice.
"""
from __future__ import annotations

import numpy as np


def synthetic_batches(
    *, mode="2d", batch=2, input_size=224, input_cols=8, seed=0, classes=3
):
    """Random batches with the training pipeline's exact shapes/dtypes, in
    the JAX package's numpy draws (sampler.py:355-370).

    For benchmarks and tests that need the device path without LiTS on disk.
    """
    rng = np.random.default_rng(seed)
    while True:
        if mode == "2d":
            image = rng.normal(0, 60, (batch, input_size, input_size, 3)).astype(np.float32)
            label = rng.integers(0, classes, (batch, input_size, input_size), dtype=np.int32)
        else:
            image = rng.normal(0, 60, (batch, input_size, input_size, input_cols, 1)).astype(np.float32)
            label = rng.integers(0, classes, (batch, input_size, input_size, input_cols), dtype=np.int32)
        yield {"image": image, "label": label}
