"""Checkpoints: the hardened single-file engine store (atomic save,
verify, namespaced names, retention) and the trainer's pytree store
(`store.save`, `restore`, `latest_step`, `AsyncWriter`); port of
`repro/ckpt`."""
from repro_torch.ckpt.store import (  # noqa: F401
    CheckpointCorrupt,
    RetentionPolicy,
    checkpoint_name,
    list_checkpoints,
    save_atomic,
    verify,
)
