"""The port's RNG against weekend_raytracer_tpu.ops.rng, bit for bit.

Inputs are numpy-seeded uint32 values, including 0, 2^31 and 2^32 - 1: the
port keeps uint32 in masked int64 (PyTorch's CPU backend has no uint32
shifts or adds), so the values >= 2^31 are where a sign or shift slip
would show.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from weekend_raytracer_tpu.ops import rng as jrng  # noqa: E402
from weekend_raytracer_tpu_torch.ops import rng as trng  # noqa: E402


def _u32(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    x[:5] = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    return x


def _as_np_u32(t):
    out = t.numpy()
    assert out.min() >= 0 and out.max() < 2 ** 32
    return out.astype(np.uint32)


def test_jenkins_hash_bit_exact():
    x = _u32(4096, 0)
    ref = np.asarray(jrng.jenkins_hash(jnp.asarray(x)))
    np.testing.assert_array_equal(_as_np_u32(trng.jenkins_hash(torch.from_numpy(x.astype(np.int64)))), ref)


@pytest.mark.parametrize("frame,sample", [(0, 0), (7, 3), (2 ** 31 + 11, 31),
                                          (2 ** 32 - 1, 2 ** 31 + 5)])
def test_init_sample_state_bit_exact(frame, sample):
    pix = _u32(4096, 1)
    ref = np.asarray(jrng.init_sample_state(jnp.asarray(pix), jnp.uint32(frame),
                                            jnp.uint32(sample)))
    got = trng.init_sample_state(torch.from_numpy(pix.astype(np.int64)), frame, sample)
    np.testing.assert_array_equal(_as_np_u32(got), ref)


def test_draw_stream_bit_exact():
    """Sixteen draws (a camera ray and three bounces) from each of 4096
    states: states and floats both bit for bit."""
    js = jnp.asarray(_u32(4096, 2))
    ts = torch.from_numpy(_u32(4096, 2).astype(np.int64))
    for _ in range(16):
        js, jv = jrng.next_float(js)
        ts, tv = trng.next_float(ts)
        np.testing.assert_array_equal(_as_np_u32(ts), np.asarray(js))
        assert tv.dtype == torch.float32
        np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                      np.asarray(jv).view(np.uint32))


def test_next_floats_matches_repeated_next_float():
    s = torch.from_numpy(_u32(256, 3).astype(np.int64))
    s4, vals = trng.next_floats(s, 4)
    for v in vals:
        s, w = trng.next_float(s)
        torch.testing.assert_close(v, w, rtol=0, atol=0)
    torch.testing.assert_close(s4, s, rtol=0, atol=0)
    assert all(float(v.min()) >= 0.0 and float(v.max()) < 1.0 for v in vals)
