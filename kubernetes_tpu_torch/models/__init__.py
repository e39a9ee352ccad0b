"""The batched assignment step, its resident state, and batched
preemption's device programs."""
