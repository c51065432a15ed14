"""Device-mesh configuration for the decode runtime.

The codec's only semantic parallel axis is "independent work units"
(LZMA2 dict-reset segments / `.xz` blocks), so the mesh is 1-D data
parallelism (``dp``). Multi-dimensional meshes still matter operationally:
across several hosts the ``dp`` axis spans (hosts x cards) and the
scheduler keeps each segment on one card so outputs never cross devices —
reassembly offsets are known before decode from the container index
(lzma-rs ``src/decode/xz.rs:109-136``), so no dynamic
load-balancing collectives are needed for bit-exactness.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Decode-runtime mesh: ``n_devices`` local devices on one ``dp``
    axis (None = all local devices)."""

    n_devices: Optional[int] = None

    def make_mesh(self):
        import numpy as np
        import jax
        from jax.sharding import Mesh

        devs = jax.devices()
        n = self.n_devices or len(devs)
        return Mesh(np.array(devs[:n]), axis_names=("dp",))
