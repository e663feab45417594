"""The v2 step's plain version at 19 and 20 qubits (the sweep kernel's
band) against the JAX package's own path there, in complex128.

From 2^19 amplitudes the JAX optimizer's ``fused_step`` runs a
host-stepped Adam around an XLA value-and-grad body
(``tensorrl_qas_tpu/optim/angle_opt.py:_host_stepped``,
``_fused_step_hostloop``), the function its v2 kernel computes below.  No
19- or 20-qubit problem but the 20q Heisenberg config ships, so the test
builds the Heisenberg chain with the JAX package's
``heisenberg_hamiltonian`` and hands its terms to the port's ``PauliSum``.
The JAX starts are injected (the two packages' generators differ), one
env, 2 starts, a short tape, 2 Adam iterations: x_opt and e_new agree to
1e-10 (both are float64 throughout; summation order alone differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrl_qas_tpu.optim.angle_opt import AngleOptimizer as OptJax
from tensorrl_qas_tpu.optim.angle_opt import make_multistarts as starts_jax
from tensorrl_qas_tpu_torch.ops import fused_adam2d
from tensorrl_qas_tpu_torch.optim.angle_opt import AngleOptimizer
from tests.test_torch_fused_adam import _ints, _random_batch
from tests.test_torch_fused_adam2d import _heisenberg, _psi


@pytest.fixture
def one_thread():
    """Torch on one thread (see tests/test_torch_v2_cluster.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [19, 20])
def test_plain_version_matches_host_stepped_jax_path(n, one_thread):
    ps_j, ps_t = _heisenberg(n)
    cap, iters, s_n = 6, 2, 2
    rng = np.random.default_rng(n)
    old, new, maps, x0, n_rots = _random_batch(rng, n, 1, cap)
    psi0 = _psi(rng, n)
    opt_j = OptJax(ps_j.device_arrays(jnp.complex128), iters=iters,
                   n_starts=s_n, lr=0.1, dtype=jnp.complex128)
    key = jax.random.PRNGKey(5)
    assert opt_j._host_stepped(jnp.asarray(psi0))
    xj, ej, _ = opt_j.fused_step(
        jnp.asarray(psi0), tuple(a[0] for a in old), x0[0], int(n_rots[0]),
        tuple(a[0] for a in new), maps[0], key)
    # the host loop's starts: fused_step splits key -> (ko, ke), then ko ->
    # (kn, ko2), and draws from kn
    active = (np.arange(cap)[None, :] < n_rots[:, None]).astype(np.float64)
    starts = np.asarray(starts_jax(
        jnp.asarray(x0[0]), jnp.asarray(active[0]),
        jax.random.split(jax.random.split(key)[0])[0], opt_j.n_starts,
        opt_j.fresh_starts, opt_j.restart_scale))[None]
    opt = AngleOptimizer(ps_t, iters=iters, n_starts=s_n, device="cpu")
    assert opt._pick_engine(old[0]) == "v2"
    p0 = torch.as_tensor(psi0)
    xt, et = fused_adam2d.fused_adam_step2d(
        _ints(old), _ints(new), torch.as_tensor(maps),
        p0.real[None].contiguous(), p0.imag[None].contiguous(),
        *opt.w_planes(), torch.as_tensor(starts),
        torch.as_tensor(active[:, None, :]), iters=iters, lr=0.1)
    np.testing.assert_allclose(xt.numpy()[0], np.asarray(xj), atol=1e-10)
    np.testing.assert_allclose(float(et[0]) + opt.offset, ej, atol=1e-10)
