"""repro_torch — the PyTorch/CUDA port of the multicore-aware CWC
simulator.

The package stands alone: it imports torch and numpy, never JAX and
never the JAX package `repro`. Its entry points (`repro_torch.api`) run
on the CUDA device unless the caller passes `device="cpu"`; with no
device argument and no GPU they raise instead of quietly running on the
CPU.

Layout (each module names the reference module it ports):

  core/stream.py      counter-based threefry RNG, records, sinks
  core/mathf.py       the port-owned float32 log and exp
  core/cwc/           CWC terms, rules, compiler and model library
  core/reactions.py   ReactionSystem and rates-first propensities
  core/gillespie.py   lane pool, the dense and sparse exact SSA steps
  core/tau_leap.py    adaptive tau-leaping (dense and sparse tables)
  core/reduction.py   blocked Welford statistics
  core/scheduler.py   lane-group scheduling policies
  core/dispatch.py    window bodies (unfused and fused-kernel), the
                      fused, sharded and host-loop strategies
  core/engine.py      SimConfig and SimulationEngine
  ckpt/               the single-file engine store and the trainer's
                      pytree store
  stats/, steer/      sketches and the between-block steering policy
  runtime/            typed faults, the straggler watchdog, the
                      supervised recovery loop and the multi-process
                      farm (coordinator and worker processes)
  kernels/            the hand-written CUDA kernels (exact and tau-leap
                      windows, Match), their plain twins, the chunk
                      loops and the nvcc build
  configs/, models/   the LM skeleton's configs and model zoo (dense,
                      MoE, VLM): build_model, CausalLM, models/moe.py
  train/, data/       the one-device trainer (AdamW, the train step,
                      the crash drill) and the synthetic token pipeline
  tree.py             nested containers walked in the reference's order
  api/                Experiment spec, simulate(), SimulationResult
  launch/simulate.py  the command line (python -m
                      repro_torch.launch.simulate)
  interop.py          state exchange with the reference's arrays
"""
