"""Multi-host initialization and process-spanning meshes.

The reference has no multi-process support of any kind (SURVEY.md §2.3); this
is the build-side component that takes the same row-partitioned SPMD solve
from one device to many hosts:

* within a host, the ``rows``-axis collectives (halo ``ppermute``, inner
  ``psum``) ride the devices' direct links;
* across hosts they ride the network — keep the ``rows`` axis contiguous
  within a host (the default process-major device order does this) so most
  halo exchanges stay on the fast links.

Usage on each host of a multi-host job::

    from krylov_tpu.parallel import multihost
    multihost.initialize()                  # jax.distributed.initialize()
    mesh = multihost.global_mesh()          # all devices, (rows, rhs)
    sol, info = parallel.sharded_solve(krylov_tpu.cg, A, b, mesh=mesh)

Every host must call :func:`initialize` before any jax computation and pass
identical global arrays to :func:`sharded_solve` (it shards them itself via
``shard_map``; for host-sharded input data use
``jax.make_array_from_process_local_data``).
"""

import jax


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize the multi-host runtime (idempotent).

    With no arguments, relies on the cluster environment (cluster-manager
    metadata / ``JAX_COORDINATOR_ADDRESS`` etc.), matching ``jax.distributed``'s
    auto-detection.

    Failure semantics: when the caller passed EXPLICIT multi-process
    parameters, initialization errors re-raise — a misconfigured pod must
    fail loudly, not silently degrade to a single-process run.  Only the
    zero-argument form (auto-detection) tolerates a single-process
    environment, and "already initialized" is always a no-op.
    """
    explicit = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
    )
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # jax raises "distributed.initialize should only be called once."
        # on re-init (jax._src.distributed); older versions said "already
        # initialized" — both mean the runtime is up, which is the
        # documented no-op
        msg = str(e).lower()
        if "already initialized" in msg or "only be called once" in msg:
            return
        if explicit:
            raise
    except ValueError:
        if explicit:
            raise
        # zero-argument auto-detection in a single-process environment


def global_mesh(n_rhs=1):
    """A ``(rows, rhs)`` mesh over every device in the job.

    Device order follows ``jax.devices()`` (process-major), so contiguous
    ``rows`` shards share a host and the halo ``ppermute`` crosses the
    network only at host boundaries.
    """
    from .mesh import make_mesh

    return make_mesh(n_rhs=n_rhs)


def process_info():
    """(process_index, process_count, local_device_count) for logging."""
    return (
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
    )
