"""Model zoo of the port: the dense and VLM families on the shared block
substrate (the reference's `repro.models`)."""


def build_model(cfg, topo=None, *, device=None):
    """Build the model for `cfg` on one device: the topology's, else
    `device` (default: the CUDA device). Every registered architecture
    is decoder-only. The mixture-of-experts family is refused: its FFN
    (`models/moe.py`) is ROADMAP queue 1 item 18b, and no model runs
    without its experts."""
    from repro_torch.models.blocks import MOE_UNPORTED
    from repro_torch.models.causal_lm import CausalLM

    if cfg.family == "moe" or cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: {MOE_UNPORTED}")
    return CausalLM(cfg, topo, device=device)
