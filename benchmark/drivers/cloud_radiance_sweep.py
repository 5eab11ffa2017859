"""All-sky shortwave radiance sweep: `radiance_sweep`'s loop over columns
with a Cloud C.1 deck laid into every column (`yardstick/cloud.py`).  Each
chunk is ``make_batched_problem`` -> ``solve_intensity(probes_per_layer=True)``
with the Nakajima-Tanaka corrections over the configuration's moments, one
probe just above each layer's bottom and a few azimuths -> ``.cpu()``."""

from __future__ import annotations

from drivers import radiance_sweep
from yardstick import cloud


class Driver(radiance_sweep.Driver):
    def __init__(self, config, traffic, seed, device, probe):
        super().__init__(config, traffic, seed, device, probe)
        cloud.add_deck(self.pool.arrays, config, seed)
