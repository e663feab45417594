"""Riemannian optimizers on the unitary manifold U(d), in torch.

Used to fit brickwork circuits of SU(4) gates to a target MPS by overlap
maximization (the reference's approach, ``dmrg-to-qc/stiefel_opt.py`` /
``mps2qc.py:242-339``).  The math is the standard Cayley-retraction toolkit:

  - Riemannian gradient (canonical metric): W = G U^H - U G^H, skew-Hermitian,
    where G is the Euclidean gradient of a real loss w.r.t. U;
  - Cayley retraction: U(tau) = (I + tau/2 W)^(-1) (I - tau/2 W) U, which
    stays exactly on U(d) for any step size;
  - vector transport of momentum/velocity by the same Cayley map.

The port of the JAX package's ``tn/stiefel.py``.  Its ``lax.scan`` over the
iteration budget becomes a loop of one in-place step over the full
(n_gates, d, d) batch; the loss history stays on the device and is read
once at the end.  On a CUDA device the step is captured once as a CUDA
graph and replayed ``maxiter`` times (``graph=False`` runs it eagerly),
so an iteration costs no host launches.

Gradient convention: for a real loss of a complex leaf, torch's ``.grad``
is dL/dRe + i dL/dIm, already the Euclidean descent direction that the JAX
package gets by conjugating ``jax.value_and_grad``'s result; nothing here
conjugates it.

Precision is the parameters' own: the warm start runs in complex128 on
the card as on the CPU, with Adam's second moment in float64.
"""

from __future__ import annotations

import gc
import math

import torch


def _h(m):
    return m.conj().transpose(-1, -2)


def riemannian_grad(g, u):
    """Project the Euclidean gradient to the tangent space (skew-Hermitian
    generator W)."""
    return g @ _h(u) - u @ _h(g)


def _cayley(w, tau):
    """(I + tau/2 W, I - tau/2 W) for a batch of generators."""
    eye = torch.eye(w.shape[-1], dtype=w.dtype, device=w.device)
    return eye + (tau / 2) * w, eye - (tau / 2) * w


def _solve(a, b):
    # solve_ex: no error check, which would read the status on the host
    return torch.linalg.solve_ex(a, b, check_errors=False)[0]


def cayley_step(u, w, tau):
    """Move along -W with step tau via the Cayley transform (exactly
    unitary for any tau)."""
    a, b = _cayley(w, tau)
    return _solve(a, b @ u)


def transport(m, w, tau):
    """Transport a Lie-algebra direction (skew-Hermitian m) along the
    Cayley move generated by w: conjugation by the Cayley rotation, which
    preserves skew-Hermiticity exactly."""
    a, b = _cayley(w, tau)
    return _rotate(m, _solve(a, b))     # unitary for skew w


def _rotate(m, c):
    out = c @ m @ _h(c)
    return (out - _h(out)) / 2          # numerical re-skew


def _step_and_transport(u, m, w, tau):
    """(cayley_step(u, w, tau), transport(m, w, tau)) from one solve of
    I + tau/2 W for both right-hand sides."""
    a, b = _cayley(w, tau)
    d = u.shape[-1]
    x = _solve(a, torch.cat([b @ u, b], dim=-1))
    return x[..., :d], _rotate(m, x[..., d:])


def metric(x, y):
    """Canonical inner product on the tangent space (real part of trace)."""
    return torch.real(torch.sum(x.conj() * y, dim=(-2, -1)))


class _StiefelBase:
    def __init__(self, lr: float = 1e-2, maxiter: int = 1000,
                 tol: float = 1e-10, graph: bool = True):
        self.lr = lr
        self.maxiter = maxiter
        self.tol = tol
        self.graph = graph
        self.opt_params = None
        self.loss_history = None

    def minimize(self, loss_fn, params0):
        """Minimize a real loss over a (G, d, d) batch of unitaries.

        Returns the best iterate (a tensor on the parameters' device):
        an iterate replaces the best so far only where its loss is
        strictly lower, and the final iterate is compared the same way.
        """
        u0 = torch.as_tensor(params0)
        state = self._init_state(u0.clone())
        state["best_u"] = u0.clone()
        state["best_loss"] = torch.full((), math.inf,
                                        dtype=_real(u0.dtype),
                                        device=u0.device)
        state["i"] = torch.zeros((), dtype=torch.int64, device=u0.device)
        state["hist"] = torch.empty(self.maxiter, dtype=_real(u0.dtype),
                                    device=u0.device)

        def step():
            self._step(loss_fn, state)

        if u0.is_cuda and self.graph and self.maxiter > 0:
            _replay(step, self.maxiter, state)
        else:
            for _ in range(self.maxiter):
                step()
        with torch.no_grad():
            final_loss = loss_fn(state["u"])
            better = final_loss < state["best_loss"]
            self.opt_params = torch.where(better, state["u"],
                                          state["best_u"])
        self.loss_history = state["hist"].cpu().numpy()
        return self.opt_params

    def _step(self, loss_fn, state):
        """One iteration, in place on ``state``: the loss and gradient at
        u, the update, the best-so-far record and the loss history."""
        u = state["u"].detach().requires_grad_(True)
        loss = loss_fn(u)
        (g,) = torch.autograd.grad(loss, u)
        with torch.no_grad():
            loss = loss.detach()
            u = u.detach()
            w = riemannian_grad(g, u)
            u_new = self._update(state, u, w)
            better = loss < state["best_loss"]
            state["best_u"].copy_(torch.where(better, u, state["best_u"]))
            state["best_loss"].copy_(torch.where(better, loss,
                                                 state["best_loss"]))
            state["hist"].index_copy_(0, state["i"].view(1), loss.view(1))
            state["i"].add_(1)
            state["u"].copy_(u_new)

    # subclass hooks -------------------------------------------------------

    def _init_state(self, u0):
        return {"u": u0}

    def _update(self, state, u, w):
        raise NotImplementedError


def _real(dtype):
    return torch.float64 if dtype == torch.complex128 else torch.float32


def _replay(step, n, state):
    """``step`` run once eagerly on a side stream (the warm-up that a
    capture needs: library handles and workspaces), the state put back,
    then captured as a CUDA graph and replayed ``n`` times."""
    saved = {k: v.clone() for k, v in state.items()}
    dev = state["u"].device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(dev).wait_stream(side)
    for k, v in saved.items():
        state[k].copy_(v)
    graph = torch.cuda.CUDAGraph()
    # a graph freed by the cyclic collector inside a capture invalidates
    # it: collect before the capture, and not during it
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            step()
    finally:
        if collecting:
            gc.enable()
    for _ in range(n):
        graph.replay()


class StiefelGD(_StiefelBase):
    """Plain Riemannian gradient descent (``stiefel_opt.py:157-201``)."""

    def _update(self, state, u, w):
        return cayley_step(u, w, self.lr)


class StiefelMomentumGD(_StiefelBase):
    """Heavy-ball momentum with transported momentum
    (``stiefel_opt.py:203-260``)."""

    def __init__(self, lr: float = 1e-2, beta: float = 0.9, **kw):
        super().__init__(lr=lr, **kw)
        self.beta = beta

    def _init_state(self, u0):
        return {"u": u0, "m": torch.zeros_like(u0)}

    def _update(self, state, u, w):
        m = self.beta * state["m"] + (1 - self.beta) * w
        u_new, m_new = _step_and_transport(u, m, m, self.lr)
        state["m"].copy_(m_new)
        return u_new


class StiefelAdam(_StiefelBase):
    """Bias-corrected Adam with momentum/velocity transported along the
    retraction each step (``stiefel_opt.py:263-347``)."""

    def __init__(self, lr: float = 3e-3, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8, **kw):
        super().__init__(lr=lr, **kw)
        self.beta1 = beta1
        self.beta2 = beta2
        self.eps = eps

    def _init_state(self, u0):
        return {"u": u0, "m": torch.zeros_like(u0),
                "v": torch.zeros(u0.shape[:-2], dtype=_real(u0.dtype),
                                 device=u0.device),
                "t": torch.zeros((), dtype=_real(u0.dtype),
                                 device=u0.device)}

    def _update(self, state, u, w):
        t = state["t"] + 1
        m = self.beta1 * state["m"] + (1 - self.beta1) * w
        v = self.beta2 * state["v"] + (1 - self.beta2) * metric(w, w)
        mhat = m / (1 - torch.pow(self.beta1, t))
        vhat = v / (1 - torch.pow(self.beta2, t))
        scale = self.lr / (torch.sqrt(vhat) + self.eps)
        step_dir = mhat * scale[..., None, None].to(m.dtype)
        u_new, m_new = _step_and_transport(u, m, step_dir, 1.0)
        state["m"].copy_(m_new)
        state["v"].copy_(v)
        state["t"].copy_(t)
        return u_new

