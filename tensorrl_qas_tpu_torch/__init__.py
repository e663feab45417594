"""PyTorch/CUDA port of the quantum architecture search trainer.

Mirrors the module layout of ``tensorrl_qas_tpu`` (the JAX reference, which
this package never imports): circuits, problems and sim on the host and in
eager torch, ``ops`` for the hand-written CUDA kernels, then optim, envs,
models, agents and train.

Dtype policy (the counterpart of the reference's ``configx.py``): by
default (``sim_dtype='auto'``) CPU runs are the parity path and simulate
in complex128/float64, and CUDA runs simulate in complex64/float32, with
full-f32 matrix products; ``sim_dtypes`` resolves the env's ``sim_dtype``
('auto' | 'complex64' | 'complex128', the CLI's ``--sim_dtype``) for a
device, so complex128 runs on the card too (the composed engine with the
double-precision tape kernels).  TF32 is switched off because, like the
one-pass bf16 products the reference rejected, it keeps about three
decimal digits and pushes the energy error past the 1.6e-3 Ha acceptance
threshold.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"


def as_device(device=None) -> torch.device:
    """Resolve a device argument; entry points default to the card."""
    return torch.device(DEFAULT_DEVICE if device is None else device)


SIM_DTYPES = ("auto", "complex64", "complex128")


def sim_dtypes(sim_dtype: str, device) -> tuple[torch.dtype, torch.dtype]:
    """The (complex, real) dtypes of statevector precision ``sim_dtype`` on
    ``device``: 'complex64' (float32 planes), 'complex128' (float64), or
    'auto', the device's default (``complex_dtype`` / ``real_dtype``);
    other strings raise ValueError."""
    if sim_dtype == "auto":
        return complex_dtype(device), real_dtype(device)
    if sim_dtype == "complex64":
        return torch.complex64, torch.float32
    if sim_dtype == "complex128":
        return torch.complex128, torch.float64
    raise ValueError(f"sim_dtype must be one of {SIM_DTYPES}, got "
                     f"{sim_dtype!r}")


def real_of(cdtype: torch.dtype) -> torch.dtype:
    """The real dtype of a complex statevector dtype."""
    return torch.float32 if cdtype == torch.complex64 else torch.float64


def complex_dtype(device) -> torch.dtype:
    """complex128 on the CPU (parity path), complex64 on CUDA."""
    return (torch.complex128 if as_device(device).type == "cpu"
            else torch.complex64)


def real_dtype(device) -> torch.dtype:
    """float64 on the CPU, float32 on CUDA."""
    return (torch.float64 if as_device(device).type == "cpu"
            else torch.float32)
