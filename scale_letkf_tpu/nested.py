"""One-way nested DA cycling: parent domain drives child boundaries.

Reference: multi-domain online nesting (NUM_DOMAIN/PRC_DOMAINS,
common_nml.f90:56-58; the nesting communicator split,
common_mpi_scale.f90:696-706; the BDA demos run d1→d4 telescoping nests).
Here both domains are jitted programs in one process: each cycle
the parent ensemble's start/end states are interpolated to the child grid
(model/nesting.py) and become the child's per-member Davies boundary
bracket — boundary data is a TRACED argument of the child's forecast, so
per-cycle updates cost no retrace.

Driven from TOML via a [nest] section in the experiment config
(cli/main.py `cycle` consumes it):

  [nest]
  i0 = 8.0        # parent fractional x-index of child cell (0,0)
  j0 = 8.0
  ratio = 3       # child dx = parent dx / ratio
  nx = 24
  ny = 24
  nz = 12         # child levels (may differ; interpolated in height)
  dz = 300.0
  bdy_width = 4
  bdy_tau = 120.0
"""

from __future__ import annotations

import numpy as np
import jax

from scale_letkf_tpu.model.boundary import BoundaryData
from scale_letkf_tpu.model.nesting import NestGeometry, parent_to_child
from scale_letkf_tpu.obs.types import Observations


class NestedCycleDriver:
    """Parent + child CycleDrivers coupled one-way per cycle."""

    def __init__(self, parent, child, geom: NestGeometry):
        self.parent = parent
        self.child = child
        self.geom = geom
        if child._bdy_w2d is None:
            raise ValueError(
                "child driver needs bdy_width > 0: the nest boundary is "
                "forced by the parent (Davies relaxation buffer)")
        self._zp = np.asarray(parent.grid.cz)
        self._zc = np.asarray(child.grid.cz)
        shape = (child.grid.nz, child.grid.ny, child.grid.nx)
        self._p2c = jax.jit(jax.vmap(
            lambda s: parent_to_child(s, geom, shape, self._zp, self._zc)))

    def child_boundary(self, p_start, p_end, t0: float, t1: float):
        """Per-member child boundary bracket from parent ensemble states."""
        return BoundaryData(state0=self._p2c(p_start),
                            state1=self._p2c(p_end),
                            t0=t0, t1=t1)

    def cycle(self, p_ens, c_ens, p_obs: Observations,
              c_obs: Observations, steps_parent: int,
              steps_child: int, infl_p=None, infl_c=None):
        """One coupled DA cycle. Returns (p_ens_a, c_ens_a, info dict).

        The child runs `steps_child` steps over the same wall-clock window
        as the parent's `steps_parent` (its dt is finer by the nest ratio);
        its Davies targets interpolate between the parent's start and end
        states (per member, one-way)."""
        p = self.parent
        c = self.child
        window = steps_parent * p.dycfg.dt
        p_start = p_ens
        p_fcst = p.forecast(p_ens, steps_parent)

        c.bdy = self.child_boundary(p_start, p_fcst, 0.0, window)
        c_fcst = c.forecast(c_ens, steps_child, t0=0.0)

        p_anal, p_info = p.analysis(p_fcst, p_obs, infl_field=infl_p)
        c_anal, c_info = c.analysis(c_fcst, c_obs, infl_field=infl_c)
        return p_anal, c_anal, {"parent": p_info, "child": c_info}
