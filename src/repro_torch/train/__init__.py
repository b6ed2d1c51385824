"""Training substrate on one device: the optimizer, the train step with
gradient accumulation, int8 quantisation and the crash drill; port of
`repro/train` (the data-parallel step and `compressed_psum` are ROADMAP
queue 1 item 18d)."""
