"""kernels_per_step.serve: kernels launched per sampler step (readers.launches_per_forward)."""
from portbench.readers import launches_per_forward as read  # noqa: F401
