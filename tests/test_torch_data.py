"""The port's data pipeline (`repro_torch.data.pipeline`) against the
reference's `repro.data.pipeline`: `synth_batch` bit for bit, dense and
VLM, and the prefetch matching direct reads and resuming at a step
(tests/test_data.py's cases on the port)."""
import dataclasses

import numpy as np
import pytest

from repro.configs import registry as j_registry
from repro.data import pipeline as j_pipeline
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, PrefetchPipeline, synth_batch


@pytest.mark.parametrize("name", ["llama3-8b", "internvl2-1b", "olmoe-1b-7b"])
@pytest.mark.parametrize("step,seed", [(0, 0), (7, 3)])
def test_synth_batch_bitwise_against_reference(name, step, seed):
    got = synth_batch(registry.get_smoke_config(name), 4, 16, step,
                      DataConfig(seed=seed))
    want = j_pipeline.synth_batch(j_registry.get_smoke_config(name), 4, 16,
                                  step, j_pipeline.DataConfig(seed=seed))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_synth_batch_at_full_width_against_reference():
    """The published vocabulary (the registry's config, not its smoke
    cut) at the trainer's shape."""
    got = synth_batch(registry.get_config("olmoe-1b-7b"), 2, 1024, 5)
    want = j_pipeline.synth_batch(j_registry.get_config("olmoe-1b-7b"), 2,
                                  1024, 5)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_deterministic_per_step_and_shifted():
    cfg = registry.get_smoke_config("llama3-8b")
    a = synth_batch(cfg, 4, 16, step=3)
    b = synth_batch(cfg, 4, 16, step=3)
    c = synth_batch(cfg, 4, 16, step=4)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert (a["tokens"] != c["tokens"]).any()
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["targets"][:, :-1])


def test_vlm_mask_excludes_image_positions():
    cfg = registry.get_smoke_config("internvl2-1b")
    b = synth_batch(cfg, 2, 16, step=0)
    p = cfg.frontend_tokens
    assert (b["loss_mask"][:, :p] == 0).all()
    assert (b["loss_mask"][:, p:] == 1).all()
    assert b["tokens"].shape == (2, 16 - p)
    assert b["embeds"].shape == (2, p, cfg.d_model)


def test_tokens_within_vocab():
    cfg = registry.get_smoke_config("gemma-7b")
    b = synth_batch(cfg, 4, 32, step=9)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < cfg.vocab_size


def test_prefetch_matches_direct_and_resumes():
    cfg = registry.get_smoke_config("llama3-8b")
    dcfg = DataConfig(seed=2)
    pipe = PrefetchPipeline(cfg, 2, 8, start_step=5, dcfg=dcfg)
    try:
        for want in (5, 6, 7):
            got = next(pipe)
            assert got["_step"] == want
            direct = synth_batch(cfg, 2, 8, want, dcfg)
            np.testing.assert_array_equal(got["tokens"], direct["tokens"])
            ref = j_pipeline.synth_batch(
                j_registry.get_smoke_config("llama3-8b"), 2, 8, want,
                j_pipeline.DataConfig(seed=2))
            assert got["targets"].tobytes() == ref["targets"].tobytes()
    finally:
        pipe.close()
    # a new pipeline from a later step resumes there
    pipe = PrefetchPipeline(cfg, 2, 8, start_step=7, dcfg=dcfg)
    try:
        assert next(pipe)["_step"] == 7
    finally:
        pipe.close()


def test_data_config_matches_reference():
    assert dataclasses.asdict(DataConfig()) == dataclasses.asdict(
        j_pipeline.DataConfig())
