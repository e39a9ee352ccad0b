"""Device mesh + sharded hot path."""

from .mesh import NODE_AXIS, build_sharded_assign_fn, make_mesh  # noqa: F401
