"""Multi-host runtime: jax.distributed bring-up + global-array assembly.

The reference's distribution layer is an explicit MPI communicator
hierarchy with a member↔node mapping and rank-addressed staging
(reference: scale/common/common_mpi_scale.f90:367-512 set_mem_node_proc;
scale/run/misc/k_stg.py stage-in tables for 3636 nodes). The array-native
equivalent: bring up the JAX multi-process runtime so `jax.devices()`
spans every host, build ONE (member, dy, dx) mesh over the global device
set, and let GSPMD place the collectives — there are no per-communicator
code paths to maintain.

Process-local data (each host reads its own members' restart files, the
analogue of the reference's rank-addressed stage-in) is assembled into
globally-sharded arrays with `jax.make_array_from_process_local_data`.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "init_distributed", "global_device_mesh", "ensemble_from_process_local",
]


def init_distributed(
    coordinator: str,
    num_processes: int,
    process_id: int,
    local_device_count: int | None = None,
) -> None:
    """Initialize the JAX multi-process runtime.

    coordinator: "host:port" of process 0 (reference analogue: the MPI
    launcher's rank-0 rendezvous). local_device_count forces N virtual
    host-platform devices per process — the CPU test rig; leave None on
    accelerator hosts, where the local cards are discovered.
    """
    import os
    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                f"{local_device_count}").strip()
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_device_mesh(n_member: int, n_dy: int, n_dx: int):
    """(member, dy, dx) Mesh over the GLOBAL device set (all hosts).

    Device order follows jax.devices(), which groups by process: with
    per-host chip counts dividing n_dy·n_dx, each member block lands on
    whole hosts — the reference's member↔node mapping
    (common_mpi_scale.f90:429-512) emerges from the axis order.
    """
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices())
    want = n_member * n_dy * n_dx
    if devs.size != want:
        raise ValueError(
            f"mesh {n_member}x{n_dy}x{n_dx} needs {want} devices, "
            f"have {devs.size} global")
    return Mesh(devs.reshape(n_member, n_dy, n_dx), ("member", "dy", "dx"))


def ensemble_from_process_local(mesh, local_members, member_axis: int = 0):
    """Assemble a globally member-sharded array from each process's local
    members (the analogue of rank-addressed restart stage-in).

    local_members: numpy array whose leading axis holds THIS process's
    members, concatenated in process order to form the global ensemble.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    spec = [None] * local_members.ndim
    spec[member_axis] = "member"
    sharding = NamedSharding(mesh, P(*spec))
    return jax.make_array_from_process_local_data(sharding, local_members)
