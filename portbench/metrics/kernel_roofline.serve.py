"""kernel_roofline.serve: the hand kernels' share of their roofline (readers.kernel_roofline)."""
from portbench.readers import kernel_roofline as read  # noqa: F401
