"""Device mesh construction.

Thin helpers over ``jax.make_mesh``: the framework scales by annotating
shardings over a named mesh and letting XLA insert collectives (GSPMD), so
mesh creation is the only place device topology appears.  Default axis
layout: a single ``"data"`` axis for batched small-graph training (graphs
are independent → DP is the natural first axis, SURVEY §7.2 L5), with an
optional ``"edge"`` axis reserved for edge-partitioned giant-graph mode.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh


def create_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a named device mesh.

    Defaults to a 1-D ``("data",)`` mesh over all visible devices.  The
    GPUs of one host reach each other all to all over NVLink, so the mesh
    follows the algorithm alone.
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape is required for multi-axis meshes")
        shape = (len(devices),)
    # Auto axis types, not the jax.make_mesh default (Explicit): with
    # Explicit axes, shard_map outputs carry mesh-typed NamedShardings that
    # poison later single-device ops on the same arrays (e.g. reusing
    # trained params in an unsharded model hits ShardingTypeError in
    # dynamic_update_slice).  Auto restores classic shard_map semantics.
    axis_types = (jax.sharding.AxisType.Auto,) * len(axis_names)
    return jax.make_mesh(
        tuple(shape), tuple(axis_names), devices=devices, axis_types=axis_types
    )
