"""HPC4e-like synthetic seismic wavefield (the paper's §4 dataset class),
the port of ``repro/data/seismic.py``: the same field, computed in float64
where the caller asks (CUDA unless told otherwise).

The paper's experiment dataset: 500 trials of a 3D regular 201x501x501
velocity-field mesh (25e9 points, >100 GB). This generator produces the
same *kind* of data at configurable scale: a damped traveling-wavefront
velocity field evolved per time step — the producer side of the in-transit
pipeline in examples/.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class SeismicConfig:
    nx: int = 51
    ny: int = 126
    nz: int = 126
    n_sources: int = 4
    velocity: float = 0.18       # wavefront speed in grid units / step
    damping: float = 0.02
    seed: int = 0


class SeismicField:
    """Sources and amplitudes come from ``np.random.default_rng(seed)`` as in
    the reference, so both packages make the same field from one seed."""

    def __init__(self, cfg: SeismicConfig,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        self.sources = rng.uniform(0.1, 0.9, (cfg.n_sources, 3))
        self.amps = rng.uniform(0.5, 1.5, cfg.n_sources)

        def axis(n: int) -> torch.Tensor:
            return torch.from_numpy(np.linspace(0, 1, n)).to(self.device)

        self._grid = (axis(cfg.nx)[:, None, None], axis(cfg.ny)[None, :, None],
                      axis(cfg.nz)[None, None, :])

    def step(self, t: int) -> torch.Tensor:
        """Velocity field at time step t (nx, ny, nz) float64: superposed
        expanding shells."""
        c = self.cfg
        gx, gy, gz = self._grid
        field = torch.zeros((c.nx, c.ny, c.nz), dtype=torch.float64,
                            device=self.device)
        r_t = c.velocity * (t + 1)
        for (sx, sy, sz), a in zip(self.sources, self.amps):
            r = torch.sqrt((gx - sx) ** 2 + (gy - sy) ** 2 + (gz - sz) ** 2)
            shell = torch.exp(-((r - r_t) ** 2) / (2 * 0.03 ** 2))
            field += float(a) * float(np.exp(-c.damping * t)) * shell
        return field

    def trial(self, n_steps: int) -> Iterator[tuple[int, torch.Tensor]]:
        for t in range(n_steps):
            yield t, self.step(t)
