"""The sparse tau-leap window (`kernels/csrc/sparse_tau_window.cu`)."""
from portbench.roofline.tau import per_window  # noqa: F401

KERNEL = "sparse_tau_window_kernel"
