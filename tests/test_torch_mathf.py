"""Port parity: the port-owned float32 log against XLA:CPU's jnp.log."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.stream import bits_to_uniform as j_bits_to_uniform
from repro_torch.core.mathf import log_f32
from repro_torch.core.stream import bits_to_uniform as t_bits_to_uniform


def test_log_f32_matches_jnp_log_on_every_uniform():
    """0 differences against jit(jnp.log) on all 2^23 values that
    bits_to_uniform can produce.

    XLA:CPU contracts five of Eigen's plog multiply-adds into FMAs when
    the host has FMA; this parity holds on the x86-64 host with AVX-512
    and FMA (Intel Xeon) the reference's numbers come from. On a host
    without FMA, XLA's own jnp.log bits would differ, not the port's.
    """
    bits = np.arange(1 << 23, dtype=np.uint32) << 9
    u = np.asarray(jax.jit(j_bits_to_uniform)(jnp.asarray(bits)))
    u_port = t_bits_to_uniform(torch.from_numpy(bits.astype(np.int64)))
    assert (u_port.numpy().view(np.int32) == u.view(np.int32)).all()
    ref = np.asarray(jax.jit(jnp.log)(jnp.asarray(u)))
    got = log_f32(u_port).numpy()
    n_diff = int((got.view(np.int32) != ref.view(np.int32)).sum())
    assert n_diff == 0, f"{n_diff} of {1 << 23} logs differ from jnp.log"


def test_log_f32_wide_range_within_one_ulp(rng):
    """Beyond the uniforms: positive normal floats over 60 decades stay
    within 1 ulp of the float64 log rounded to float32."""
    x = (10.0 ** rng.uniform(-30, 30, 200_000)).astype(np.float32)
    got = log_f32(torch.from_numpy(x)).numpy()
    want = np.log(x.astype(np.float64)).astype(np.float32)
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 1
