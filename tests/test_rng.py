"""RNG sampler moment tests (unit coverage the reference lacks, SURVEY §4)."""

import jax
import jax.numpy as jnp
import numpy as np

from jaybenne_tpu.ops import rng

KEY = jax.random.PRNGKey(12)
N = 200_000


def test_isotropic_direction_moments():
    nx, ny, nz = rng.isotropic_direction(KEY, (N,), jnp.float32)
    v = np.stack([np.asarray(nx), np.asarray(ny), np.asarray(nz)])
    # unit vectors
    assert np.allclose((v**2).sum(0), 1.0, atol=1e-5)
    # isotropy: zero mean per component, <n_i^2> = 1/3
    assert np.abs(v.mean(1)).max() < 0.01
    assert np.allclose((v**2).mean(1), 1.0 / 3.0, atol=0.01)


def test_face_isotropic_direction_moments():
    """Cosine-weighted hemisphere: principal mu = sqrt(U) => E[mu] = 2/3,
    E[mu^2] = 1/2; transverse components symmetric."""
    n1, n2, n3 = rng.face_isotropic_direction(KEY, (N,), jnp.float32)
    n1, n2, n3 = map(np.asarray, (n1, n2, n3))
    assert (n1 > 0).all()
    assert abs(n1.mean() - 2.0 / 3.0) < 0.005
    assert abs((n1**2).mean() - 0.5) < 0.005
    assert abs(n2.mean()) < 0.01 and abs(n3.mean()) < 0.01
    assert np.allclose(n1**2 + n2**2 + n3**2, 1.0, atol=1e-5)


def test_exponential_moments():
    e = np.asarray(rng.exponential(KEY, (N,), jnp.float32))
    assert (e > 0).all()
    assert abs(e.mean() - 1.0) < 0.01
    assert abs(e.std() - 1.0) < 0.02


def test_uniform_pos_strictly_positive():
    u = np.asarray(rng.uniform_pos(KEY, (N,), jnp.float32))
    assert (u > 0).all() and (u < 1.0).all()
    assert np.isfinite(np.log(u)).all()


def test_pool_circle_uniform_on_circle():
    """DrawPool.circle must sample (cos phi, sin phi) exactly uniform on the
    unit circle: on-circle to f32 precision, zero means, half-unit second
    moments, uncorrelated components, and a sign-balanced sine."""
    from jaybenne_tpu.ops import pallas_rng as prng

    raw = prng.make_raw_bits(65536, jnp.uint32(1234), 0)
    pool = prng.DrawPool(raw)
    ch, sh = pool.circle(jnp.int32(0))
    c = np.asarray(ch).reshape(-1).astype(np.float64)
    s = np.asarray(sh).reshape(-1).astype(np.float64)
    n = c.size
    assert np.abs(c * c + s * s - 1.0).max() < 1e-6
    sd = 1.0 / np.sqrt(2 * n)  # var(cos) = 1/2
    assert abs(c.mean()) < 5 * sd and abs(s.mean()) < 5 * sd
    assert abs((c * c).mean() - 0.5) < 10 * sd
    assert abs((c * s).mean()) < 5 * sd  # components uncorrelated
    assert abs((s > 0).mean() - 0.5) < 5 / np.sqrt(n)
