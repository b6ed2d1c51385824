"""Model zoo of the port: the dense, MoE and VLM families on the shared
block substrate (the reference's `repro.models`)."""


def build_model(cfg, topo=None, *, device=None):
    """Build the model for `cfg` on the topology (its parameters on the
    mesh's first device), else on `device` (default: the CUDA device).
    Every registered architecture is decoder-only."""
    from repro_torch.models.causal_lm import CausalLM

    return CausalLM(cfg, topo, device=device)
