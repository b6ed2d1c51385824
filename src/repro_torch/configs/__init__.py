"""Config package: architecture, shape, mesh, hardware and run configs
(the port's copy of `repro.configs`)."""
