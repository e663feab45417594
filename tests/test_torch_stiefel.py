"""The port's Riemannian optimizers (``tensorrl_qas_tpu_torch/tn/
stiefel.py``) against the JAX package's ``tn/stiefel.py`` on the same
numpy-seeded inputs, on the CPU in complex128.

Tolerances: the primitives (Riemannian gradient, Cayley step, transport,
metric) on random (G, 4, 4) batches 1e-12; a StiefelAdam, StiefelGD and
StiefelMomentumGD run of 1 and 3 iterations from the same starting
unitaries, best iterate and loss history, 1e-12 (LAPACK's solves in
another order are all that differ).  The gradient convention: torch's
``.grad`` of a real loss of a complex leaf equals the conjugate of
``jax.grad``'s to 1e-12, so the port, unlike the JAX package, does not
conjugate it (``tn/stiefel.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrl_qas_tpu  # noqa: F401  (the JAX package's x64 setup)
from tensorrl_qas_tpu_torch.tn import circuit_fit, stiefel

G = 5


def _unitaries(rng, g=G):
    from scipy.stats import unitary_group

    return np.asarray(unitary_group.rvs(4, size=g, random_state=rng))


def _skew(rng, g=G):
    h = rng.normal(size=(g, 4, 4)) + 1j * rng.normal(size=(g, 4, 4))
    return (h - np.conj(np.swapaxes(h, 1, 2))) / 2


def _t(x):
    return torch.as_tensor(x, dtype=torch.complex128)


@pytest.mark.parametrize("seed", [0, 1])
def test_primitives_match_jax(seed):
    from tensorrl_qas_tpu.tn import stiefel as sj

    rng = np.random.default_rng(seed)
    u, g = _unitaries(rng), rng.normal(size=(G, 4, 4)) + 1j * rng.normal(
        size=(G, 4, 4))
    w, m = _skew(rng), _skew(rng)
    pairs = (
        (stiefel.riemannian_grad(_t(g), _t(u)), sj.riemannian_grad(g, u)),
        (stiefel.cayley_step(_t(u), _t(w), 0.3), sj.cayley_step(u, w, 0.3)),
        (stiefel.transport(_t(m), _t(w), 0.7), sj.transport(m, w, 0.7)),
        (stiefel.metric(_t(w), _t(m)), sj.metric(w, m)),
    )
    for ours, theirs in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=1e-12, rtol=0)
    # the Cayley step stays on U(4) and the transport skew-Hermitian
    step = stiefel.cayley_step(_t(u), _t(w), 0.3).numpy()
    np.testing.assert_allclose(step @ np.conj(np.swapaxes(step, 1, 2)),
                               np.broadcast_to(np.eye(4), (G, 4, 4)),
                               atol=1e-12)
    tr = stiefel.transport(_t(m), _t(w), 0.7).numpy()
    np.testing.assert_allclose(tr, -np.conj(np.swapaxes(tr, 1, 2)),
                               atol=1e-15)


def test_gradient_is_the_conjugate_of_jax_grad():
    """torch's gradient of a real loss of a complex leaf is dL/dRe +
    i dL/dIm, the conjugate of jax.grad's: |z - a|^2 at z = 0.3 - 0.7i,
    a = 1 + 2i gives -1.4 - 5.4i in torch, -1.4 + 5.4i in JAX; and on a
    brick loss over a (G, 4, 4) batch the two are conjugates to 1e-12."""
    a = 1 + 2j
    z = torch.tensor(0.3 - 0.7j, dtype=torch.complex128, requires_grad=True)
    (torch.abs(z - a) ** 2).backward()
    g_jax = complex(jax.grad(lambda x: jnp.abs(x - a) ** 2)(
        jnp.asarray(0.3 - 0.7j, dtype=jnp.complex128)))
    assert complex(z.grad) == pytest.approx(-1.4 - 5.4j, abs=1e-12)
    assert g_jax == pytest.approx(-1.4 + 5.4j, abs=1e-12)

    loss_t, loss_j, u0 = _fit_losses(4, seed=3)
    u = _t(u0).requires_grad_(True)
    (g_t,) = torch.autograd.grad(loss_t(u), u)
    g_j = jax.grad(loss_j)(jnp.asarray(u0))
    np.testing.assert_allclose(g_t.numpy(), np.conj(np.asarray(g_j)),
                               atol=1e-12, rtol=0)


def _fit_losses(n, seed):
    """1 - |<target|psi(U)>| on a brickwork of 2 layers at n qubits, in
    each package, with a random target and starting unitaries."""
    from tensorrl_qas_tpu.tn.circuit_fit import circuit_state as state_jax

    rng = np.random.default_rng(seed)
    target = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    target /= np.linalg.norm(target)
    pairs = circuit_fit.brickwork_pairs(n, 2)
    u0 = circuit_fit.initial_params(len(pairs), seed=seed)
    tt, tj = _t(target), jnp.asarray(target)

    def loss_t(u):
        psi = circuit_fit.circuit_state(u, pairs, n)
        return 1.0 - torch.abs(torch.vdot(tt, psi))

    def loss_j(u):
        return 1.0 - jnp.abs(jnp.vdot(tj, state_jax(u, pairs, n)))

    return loss_t, loss_j, u0


@pytest.mark.parametrize("maxiter", [1, 3])
@pytest.mark.parametrize("name,kw", [("StiefelAdam", {"lr": 1e-2}),
                                     ("StiefelGD", {"lr": 0.1}),
                                     ("StiefelMomentumGD", {"lr": 0.1})])
def test_optimizer_steps_match_jax(name, kw, maxiter):
    """From the same starting unitaries (the fit's identity-plus-jitter
    start), 1 and 3 iterations give the JAX package's best iterate and
    loss history to 1e-12."""
    from tensorrl_qas_tpu.tn import stiefel as sj

    loss_t, loss_j, u0 = _fit_losses(4, seed=0)
    ours = getattr(stiefel, name)(maxiter=maxiter, **kw)
    theirs = getattr(sj, name)(maxiter=maxiter, **kw)
    p_t = ours.minimize(loss_t, _t(u0))
    p_j = theirs.minimize(loss_j, jnp.asarray(u0))
    np.testing.assert_allclose(p_t.numpy(), p_j, atol=1e-12, rtol=0)
    np.testing.assert_allclose(ours.loss_history, theirs.loss_history,
                               atol=1e-12, rtol=0)
    assert ours.loss_history.shape == (maxiter,)


def test_best_iterate_keeps_the_strictly_lower_loss():
    """At a step size that overshoots, the final iterate is not the best:
    the returned unitaries are those of the lowest loss in the history
    (the first of equal ones), as in the JAX package."""
    from tensorrl_qas_tpu.tn import stiefel as sj

    loss_t, loss_j, u0 = _fit_losses(4, seed=1)
    ours, theirs = stiefel.StiefelGD(lr=3.0, maxiter=6), sj.StiefelGD(
        lr=3.0, maxiter=6)
    p_t = ours.minimize(loss_t, _t(u0))
    p_j = theirs.minimize(loss_j, jnp.asarray(u0))
    hist = ours.loss_history
    assert np.argmin(hist) < len(hist) - 1     # the last is not the best
    with torch.no_grad():
        assert float(loss_t(p_t)) == pytest.approx(hist.min(), abs=1e-14)
    np.testing.assert_allclose(p_t.numpy(), p_j, atol=1e-12, rtol=0)
