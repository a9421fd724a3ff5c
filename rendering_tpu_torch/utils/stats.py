"""Render statistics — the port's copy of `rendering_tpu.utils.stats`,
the analogue of the reference's `include/stats.h`.

The device counters come back from a render (`aux["stats"]`); the build
counters (triangle copies, BVH nodes) from the scene's static. Notes:

  * ray_tri_tests / accel_struct_tests count the tests the intersection
    kernels perform (the K3 counters): they prune by the running t,
    which the reference does not, so they are below the reference's
    counts, a work oracle with the JAX package's semantics.
  * rays_casted counts trace() invocations (primary + shadow), like
    `stats::raysCasted` (`src/scene.cpp:727-729`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RenderStats:
    ray_tri_tests: int = 0
    accel_struct_tests: int = 0
    tri_copies_count: int = 0
    mesh_count: int = 0
    ac_count: int = 0
    rays_casted: int = 0

    def add_device_counts(self, counts: dict) -> None:
        self.ray_tri_tests += int(counts.get("ray_tri_tests", 0))
        self.accel_struct_tests += int(counts.get("accel_struct_tests", 0))
        self.rays_casted += int(counts.get("rays_casted", 0))

    def print_stats(self) -> None:
        # Mirrors stats::printStats (include/stats.h:18-36).
        print("Statistics:")
        print(f"Ray triangle tests:                 {float(self.ray_tri_tests):10.2e}")
        print(f"Ray acceleration structure tests:   {float(self.accel_struct_tests):10.2e}")
        total = float(self.ray_tri_tests + self.accel_struct_tests)
        print(f"Total intersection test:            {total:10.2e}")
        print(f"Total triangle copies:              {self.tri_copies_count:10}")
        print(f"Total triangle count:               {self.mesh_count:10}")
        print(f"Acceleration structure count:       {self.ac_count:10}")
        print(f"Rays casted:                        {self.rays_casted:10}")
