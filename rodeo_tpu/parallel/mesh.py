r"""
Device-mesh helpers.

The natural scale-out axes for this library are *embarrassingly parallel*:
MCMC chains, parameter-sweep candidates, and independent ODE solves.  They
shard over NVLink as pure data parallelism — no collective traffic inside a
solve — so a 1-D mesh saturates multi-chip topologies (SURVEY.md §5).
"""
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["make_mesh", "batch_sharding", "replicated_sharding"]


def make_mesh(n_devices=None, axis_name="batch"):
    """
    Build a 1-D device mesh over the first ``n_devices`` devices
    (default: all).

    Args:
        n_devices (int | None): Number of devices.
        axis_name (str): Mesh axis name.

    Returns:
        (jax.sharding.Mesh): The mesh.
    """
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    # Auto axis type: let GSPMD propagate shardings instead of requiring
    # explicit sharding annotations on every intermediate (jax>=0.7 defaults
    # to Explicit, which rejects mixed sharded/replicated ops in vmap/scan).
    return jax.make_mesh((len(devices),), (axis_name,),
                         axis_types=(jax.sharding.AxisType.Auto,),
                         devices=devices)


def batch_sharding(mesh, axis_name="batch"):
    """NamedSharding that splits the leading array axis over the mesh."""
    return NamedSharding(mesh, PartitionSpec(axis_name))


def replicated_sharding(mesh):
    """NamedSharding that replicates an array on every device."""
    return NamedSharding(mesh, PartitionSpec())
