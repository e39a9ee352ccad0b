"""The batched assignment step, its resident state, and batched
preemption's device programs."""

from .assign import build_assign_fn  # noqa: F401
