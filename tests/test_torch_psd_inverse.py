"""The port's batched SPD inverse (``ops/linalg_cuda.py``) against the JAX
package: the plain version against the Pallas kernel in interpret mode at
small n (interpret mode takes minutes at n = 39) and against
``smallmat.psd_inverse`` at the flagship's sizes, all in float64."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# one intra-op thread: the suite's workers share the host's cores, where
# oversubscribed OpenMP barriers make small batched ops ~100x slower
torch.set_num_threads(1)


def _random_spd(rng, B, n, cond=1e3):
    U, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
    ev = np.logspace(0, np.log10(cond), n)[None, :]
    return (U * ev[:, None, :]) @ np.swapaxes(U, -1, -2)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("n", [6, 20])
def test_plain_matches_interpreted_pallas(n):
    from libdwbc_tpu.ops.pallas_linalg import pallas_psd_inverse
    from libdwbc_tpu_torch.ops.linalg_cuda import psd_inverse_plain

    A = _random_spd(np.random.default_rng(n), 8, n)
    ref = np.asarray(pallas_psd_inverse(jnp.asarray(A), interpret=True))
    got = psd_inverse_plain(torch.as_tensor(A)).numpy()
    assert _rel(got, ref) <= 1e-12


@pytest.mark.parametrize("n", [33, 39])
def test_plain_matches_smallmat_at_tick_sizes(n):
    from libdwbc_tpu.ops import smallmat as jsm
    from libdwbc_tpu_torch.ops.linalg_cuda import psd_inverse_plain

    A = _random_spd(np.random.default_rng(n), 4, n, cond=1e5)
    ref = np.asarray(jsm.psd_inverse(jnp.asarray(A)))
    got = psd_inverse_plain(torch.as_tensor(A)).numpy()
    assert _rel(got, ref) <= 1e-10
    assert _rel(got, np.linalg.inv(A)) <= 1e-9


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_output_is_exactly_symmetric(dtype):
    from libdwbc_tpu_torch.ops.linalg_cuda import psd_inverse_plain

    A = torch.as_tensor(_random_spd(np.random.default_rng(1), 5, 39), dtype=dtype)
    out = psd_inverse_plain(A)
    assert torch.equal(out, out.transpose(-1, -2))


def test_plain_reads_only_the_lower_triangle():
    from libdwbc_tpu_torch.ops.linalg_cuda import psd_inverse_plain

    A = torch.as_tensor(_random_spd(np.random.default_rng(2), 3, 20))
    junk = A + torch.triu(torch.full_like(A, 7.0), 1)
    assert torch.equal(psd_inverse_plain(junk), psd_inverse_plain(A))


def test_wrapper_on_cpu_is_the_plain_version():
    from libdwbc_tpu_torch.ops import linalg_cuda

    A = torch.as_tensor(_random_spd(np.random.default_rng(4), 6, 33), dtype=torch.float32)
    n0 = linalg_cuda.launches["psd_inverse"]
    assert torch.equal(linalg_cuda.psd_inverse(A), linalg_cuda.psd_inverse_plain(A))
    assert linalg_cuda.launches["psd_inverse"] == n0
    assert not linalg_cuda.use_kernel(A, "cuda")


def test_smallmat_psd_inverse_matches_jax():
    from libdwbc_tpu.ops import smallmat as jsm
    from libdwbc_tpu_torch.ops import smallmat as sm

    A = _random_spd(np.random.default_rng(5), 4, 12, cond=1e4)
    assert _rel(sm.psd_inverse(torch.as_tensor(A)).numpy(),
                np.asarray(jsm.psd_inverse(jnp.asarray(A)))) <= 1e-11


@pytest.mark.parametrize("n", [16, 33, 39])
def test_psd_inverse_flops_count_the_kernel_loops(n):
    """chip_smoke.py's operation count of one inverse, against a count of the
    loops of csrc/elemlin.cuh (chol_factor, tri_inv_lower, ltl_sym)."""
    from libdwbc_tpu_torch.ops.linalg_cuda import psd_inverse_flops

    fma = other = 0
    for j in range(n):                               # chol_factor
        other += 1 + (n - j)
        fma += sum(i - j for i in range(j + 1, n))
    for j in range(n):                               # tri_inv_lower
        for i in range(j + 1, n):
            fma += i - j
            other += 1
    for i in range(n):                               # ltl_sym
        for j in range(i, n):
            fma += n - j
    assert psd_inverse_flops(n) == 2 * fma + other
