"""The dense tau-leap window (`kernels/csrc/tau_window.cu`)."""
from portbench.roofline.tau import per_window  # noqa: F401

KERNEL = "tau_window_kernel"
