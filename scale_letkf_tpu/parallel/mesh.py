"""Device mesh and sharding layout for the (member × domain) parallelization.

Batched replacement for the reference's MPI communicator hierarchy
(reference: scale/common/common_mpi_scale.f90:517-921 — COMM_e ensemble
communicator, COMM_d 2-D domain decomposition, member↔node mapping
set_mem_node_proc :367). Here the whole hierarchy is one
jax.sharding.Mesh with axes:

  member — the ensemble axis (COMM_e); mean/spread/obs-ensval reductions
           become psum/all_gather over this axis
  dy, dx — the 2-D horizontal domain decomposition (COMM_d); stencil halo
           traffic rides jnp.roll → collective-permute under GSPMD

The reference's nitmax sequential member iterations (more members than
slots) are unnecessary: members beyond the mesh size stay as a local batch
dimension on each device group.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scale_letkf_tpu.model.dycore import DycoreState

AXIS_MEMBER = "member"
AXIS_DY = "dy"
AXIS_DX = "dx"


def make_mesh(n_member: int = 1, n_dy: int = 1, n_dx: int = 1,
              devices=None) -> Mesh:
    """Create the (member, dy, dx) mesh. Total devices must equal the
    product; pass devices explicitly to control placement."""
    if devices is None:
        devices = jax.devices()
    need = n_member * n_dy * n_dx
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_member, n_dy, n_dx)
    return Mesh(arr, (AXIS_MEMBER, AXIS_DY, AXIS_DX))


def ensemble_state_sharding(mesh: Mesh) -> DycoreState:
    """NamedShardings for an ensemble DycoreState with layout
    (K, [q,] nz, ny, nx): member on the ensemble axis, ny/nx on the domain
    axes, nz replicated (the reference never decomposes the vertical —
    SURVEY §2.4)."""
    def ns(*spec):
        return NamedSharding(mesh, P(*spec))
    s4 = ns(AXIS_MEMBER, None, AXIS_DY, AXIS_DX)          # (K, nz, ny, nx)
    s5 = ns(AXIS_MEMBER, None, None, AXIS_DY, AXIS_DX)    # (K, NQ, nz, ny, nx)
    return DycoreState(rho=s4, rhou=s4, rhov=s4, rhow=s4, rhot=s4, rhoq=s5)


def stacked_state_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for the stacked analysis view (K, NV3D, nz, ny, nx)."""
    return NamedSharding(mesh, P(AXIS_MEMBER, None, None, AXIS_DY, AXIS_DX))


def gridpoint_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for per-level flattened gridpoint batches (B = ny·nx, ...):
    the LETKF 'ensemble transpose' — gridpoints spread over ALL mesh axes so
    every device updates its share of analysis points
    (replaces scatter_grd_mpi_alltoall, common_mpi_scale.f90:1279)."""
    return NamedSharding(mesh, P((AXIS_MEMBER, AXIS_DY, AXIS_DX)))


def shard_ensemble(mesh: Mesh, ens: DycoreState) -> DycoreState:
    """Place an ensemble state onto the mesh."""
    sh = ensemble_state_sharding(mesh)
    return DycoreState(*(jax.device_put(a, s) for a, s in zip(ens, sh)))


def constrain_ensemble(mesh: Mesh, ens: DycoreState) -> DycoreState:
    """with_sharding_constraint version for use inside jit."""
    sh = ensemble_state_sharding(mesh)
    return DycoreState(*(jax.lax.with_sharding_constraint(a, s)
                         for a, s in zip(ens, sh)))
