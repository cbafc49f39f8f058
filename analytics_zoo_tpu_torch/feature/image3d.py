"""3D (medical) image transforms — the JAX package's
``feature/image3d.py``, copied: host scipy code on the port's
``feature/common.Preprocessing``, equal to the JAX package's bit for bit.

Reference parity: feature/image3d/*.scala (Affine, Rotation, Crop, RandomCrop) — volumes
are (D, H, W) float arrays; geometric ops via scipy.ndimage on the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import ndimage

from analytics_zoo_tpu_torch.feature.common import Preprocessing


class Crop3D(Preprocessing):
    """Crop a (d, h, w) patch starting at `start` (Crop3D parity)."""

    def __init__(self, start: Sequence[int], patch_size: Sequence[int]):
        self.start = tuple(int(i) for i in start)
        self.size = tuple(int(i) for i in patch_size)

    def transform(self, vol: np.ndarray) -> np.ndarray:
        z, y, x = self.start
        d, h, w = self.size
        return vol[z:z + d, y:y + h, x:x + w]


class CenterCrop3D(Preprocessing):
    def __init__(self, patch_size: Sequence[int]):
        self.size = tuple(int(i) for i in patch_size)

    def transform(self, vol):
        start = [(s - p) // 2 for s, p in zip(vol.shape, self.size)]
        return Crop3D(start, self.size).transform(vol)


class RandomCrop3D(Preprocessing):
    def __init__(self, patch_size: Sequence[int], seed=None):
        self.size = tuple(int(i) for i in patch_size)
        self.rng = np.random.default_rng(seed)

    def transform(self, vol):
        start = [int(self.rng.integers(0, max(1, s - p + 1)))
                 for s, p in zip(vol.shape, self.size)]
        return Crop3D(start, self.size).transform(vol)


class Rotate3D(Preprocessing):
    """Rotate by Euler angles (degrees) around the three axes (Rotation3D parity)."""

    def __init__(self, yaw: float = 0.0, pitch: float = 0.0, roll: float = 0.0,
                 order: int = 1):
        self.angles = (yaw, pitch, roll)
        self.order = order

    def transform(self, vol):
        out = vol
        for angle, axes in zip(self.angles, [(1, 2), (0, 2), (0, 1)]):
            if abs(angle) > 1e-9:
                out = ndimage.rotate(out, angle, axes=axes, reshape=False,
                                     order=self.order, mode="nearest")
        return out


class AffineTransform3D(Preprocessing):
    """Apply a 3x3 affine matrix + translation (AffineTransform3D parity)."""

    def __init__(self, matrix: np.ndarray, translation=(0.0, 0.0, 0.0),
                 order: int = 1):
        self.matrix = np.asarray(matrix, np.float64).reshape(3, 3)
        self.translation = np.asarray(translation, np.float64)
        self.order = order

    def transform(self, vol):
        center = (np.asarray(vol.shape) - 1) / 2.0
        offset = center - self.matrix @ center + self.translation
        return ndimage.affine_transform(vol, self.matrix, offset=offset,
                                        order=self.order, mode="nearest")


class Warp3D(Preprocessing):
    """Warp a volume by a dense displacement field (WarpTransformer parity:
    feature/image3d/Warp.scala).  `flow` has shape (3, D, H, W) — per-voxel
    displacements along each axis; output(v) = input(v + flow(v)) with
    linear interpolation and edge clamping."""

    def __init__(self, flow: np.ndarray, order: int = 1):
        self.flow = np.asarray(flow, np.float64)
        if self.flow.ndim != 4 or self.flow.shape[0] != 3:
            raise ValueError(f"flow must be (3, D, H, W); got "
                             f"{self.flow.shape}")
        self.order = order

    def transform(self, vol):
        if self.flow.shape[1:] != np.asarray(vol).shape:
            raise ValueError(
                f"flow field {self.flow.shape[1:]} does not match volume "
                f"{np.asarray(vol).shape}")
        grid = np.meshgrid(*[np.arange(s) for s in vol.shape], indexing="ij")
        coords = [g + f for g, f in zip(grid, self.flow)]
        return ndimage.map_coordinates(vol, coords, order=self.order,
                                       mode="nearest")
