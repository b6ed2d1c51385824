"""The ways a mix offers its jobs, one file per `loop` a mix names
(`loops/<loop>.py`, whose `drive(cell, seed, seconds, device, keep,
span)` returns the measured `harness.loop.Window`)."""
