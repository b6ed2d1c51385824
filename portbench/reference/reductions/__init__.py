"""The records a reduction makes of a window's populations, one file
per `Reduction` value (`reductions/<value>.py`, whose `fold(obs)` is
the record in float64 and `fold_bf16(obs)` the control's)."""
