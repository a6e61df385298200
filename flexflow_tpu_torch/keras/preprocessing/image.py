"""Image preprocessing: the array pieces of the reference's re-exported
keras_preprocessing.image that synthetic/offline workloads use."""

from __future__ import annotations

import numpy as np


def img_to_array(img, data_format="channels_first", dtype="float32"):
    x = np.asarray(img, dtype=dtype)
    if x.ndim == 2:
        x = x[None] if data_format == "channels_first" else x[..., None]
    elif (x.ndim == 3 and data_format == "channels_first"
          and x.shape[-1] in (1, 3, 4)):
        x = np.transpose(x, (2, 0, 1))
    return x


def array_to_img(x, data_format="channels_first"):
    x = np.asarray(x)
    if data_format == "channels_first" and x.ndim == 3:
        x = np.transpose(x, (1, 2, 0))
    x = x - x.min()
    mx = x.max()
    if mx > 0:
        x = x / mx * 255.0
    return x.astype(np.uint8)
