"""Training substrate: the optimizer, the train step with gradient
accumulation, the explicit data-parallel step over a mesh axis with the
int8 error-feedback reduction (`compressed_psum`), and the crash drill;
port of `repro/train`."""
