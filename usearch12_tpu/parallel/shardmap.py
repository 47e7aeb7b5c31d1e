"""shard_map with the replication check off.

Every shard_map call in this package goes through :func:`shard_map_norep`:
our kernels use explicit collectives whose replication the checker cannot
always prove.
"""

from __future__ import annotations

from jax import shard_map


def shard_map_norep(fn, mesh, in_specs, out_specs):
    """jax.shard_map with check_vma=False."""
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_vma=False)
