"""Device-mesh construction and multi-host initialization.

Configuration that cannot be inferred from kwargs (SURVEY §5.6): the mesh
shape and axis names are explicit. Conventions used throughout:

  * axis ``"op"`` — the operator's row axis is block-partitioned here
    (tensor-parallel analog; collectives ride the device interconnect);
  * axis ``"probe"`` — independent probe vectors are split here
    (data-parallel analog; estimator reductions are ``psum``s over it).

A 1-D mesh over all devices on the "op" axis is the default: the matvec is
the only O(n²)/O(nnz) cost, so operator sharding is the first lever. The
mesh follows the algorithm alone: on an all-to-all interconnect (NVLink) no
device order is better than another.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh

__all__ = ["make_mesh", "mesh_devices", "initialize_distributed"]


def mesh_devices(n: Optional[int] = None) -> list:
	"""First ``n`` global devices (all by default), in stable order."""
	devs = jax.devices()
	if n is not None:
		assert n <= len(devs), f"Requested {n} devices but only {len(devs)} are available."
		return devs[:n]
	return devs


def make_mesh(
	shape: Optional[Tuple[int, ...]] = None,
	axis_names: Sequence[str] = ("op", "probe"),
	devices: Optional[Sequence] = None,
) -> Mesh:
	"""Build a named device mesh for sharded estimation.

	``shape`` defaults to ``(n_devices, 1)`` — all devices shard the operator's
	row axis. Pass e.g. ``shape=(4, 2)`` to also split probes 2-way. The
	product must equal the device count used.
	"""
	devices = list(devices if devices is not None else jax.devices())
	if shape is None:
		shape = (len(devices),) + (1,) * (len(axis_names) - 1)
	assert int(np.prod(shape)) == len(devices), (
		f"Mesh shape {shape} needs {int(np.prod(shape))} devices, have {len(devices)}."
	)
	dev_array = np.asarray(devices).reshape(shape)
	return Mesh(dev_array, tuple(axis_names)[: dev_array.ndim])


def initialize_distributed(**kwargs) -> None:
	"""Multi-host entry point: join the JAX distributed runtime.

	Thin wrapper over ``jax.distributed.initialize``: pass
	``coordinator_address`` (``host:port``), ``num_processes`` and
	``process_id`` explicitly — nothing infers them on a plain GPU host.
	After this, every process sees the global device list and ``make_mesh``
	spans all of them; the estimator programs are unchanged.
	"""
	jax.distributed.initialize(**kwargs)
