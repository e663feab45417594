"""Device meshes: an (amp, dp) grid of torch devices driven by one process.

Counterpart of ``tensorrl_qas_tpu/parallel/mesh.py``.  The axes are the
JAX package's:

- ``amp``: the 2^n statevector split over devices on its top index bits
  (``parallel/sharded_sim.py``),
- ``dp``: batch rows (optimizer starts, replay samples) split over
  devices.

As in the JAX package, one process drives every device of the mesh
(single controller): a sharded value is a grid ``blocks[a][d]`` of
tensors, the block of shard (a, d) on ``mesh.devices[a][d]``, and the two
collectives the sharded code needs are copies and sums issued from that
process.  ``ppermute`` hands each destination its source shard's tensor
on the destination's device (peer to peer between cards); ``psum`` adds
the partials on one device in mesh order, so that the sum does not
depend on timing, and hands the total back to every shard's device.
A grid may hold fewer columns than the dp axis (a value with fewer rows
than shards lives on the first columns).

A device may appear more than once: ``["cuda:0"] * 8`` puts eight shards
on one card and ``["cpu"] * 8`` is the CPU twin of the JAX tests' virtual
mesh.  ``tensor.to(device)`` then returns the tensor itself, so code that
receives a block must never update it in place.
"""

from __future__ import annotations

import torch

AXES = ("amp", "dp")


class Mesh:
    """An (n_amp, n_dp) grid of devices with axes ("amp", "dp")."""

    def __init__(self, devices):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        n_amp, n_dp = len(self.devices), len(self.devices[0])
        if any(len(row) != n_dp for row in self.devices):
            raise ValueError("mesh rows must have the same length")
        self.shape = {"amp": n_amp, "dp": n_dp}
        self.axis_names = AXES

    @property
    def size(self) -> int:
        return self.shape["amp"] * self.shape["dp"]

    @property
    def lead(self) -> torch.device:
        """The device of shard (0, 0): where results are gathered."""
        return self.devices[0][0]

    def ppermute(self, blocks, axis: str, perm):
        """Each destination's block is its source's, on the destination's
        device: ``perm`` holds (source, destination) indices along
        ``axis``; a destination no pair names gets zeros (as
        ``lax.ppermute``).  ``blocks`` and the result are grids [a][d]."""
        src_of = {int(dst): int(src) for src, dst in perm}
        n_a, n_d = len(blocks), len(blocks[0])

        def moved(a, d):
            if axis == "amp":
                sa, sd = src_of.get(a), d
            else:
                sa, sd = a, src_of.get(d)
            dev = self.devices[a][d]
            if sa is None or sd is None:
                return torch.zeros_like(blocks[a][d], device=dev)
            return blocks[sa][sd].to(dev)

        _check_axis(axis)
        return [[moved(a, d) for d in range(n_d)] for a in range(n_a)]

    def psum(self, parts, axis: str):
        """The sum of ``parts`` along ``axis``, the same total on every
        shard's device: added on the line's first device in mesh order,
        then copied back.  ``parts`` and the result are grids [a][d]."""
        _check_axis(axis)
        n_a, n_d = len(parts), len(parts[0])
        out = [[None] * n_d for _ in range(n_a)]
        if axis == "amp":
            lines = [[(a, d) for a in range(n_a)] for d in range(n_d)]
        else:
            lines = [[(a, d) for d in range(n_d)] for a in range(n_a)]
        for line in lines:
            a0, d0 = line[0]
            dev = self.devices[a0][d0]
            total = parts[a0][d0].to(dev)
            for a, d in line[1:]:
                total = total + parts[a][d].to(dev)
            for a, d in line:
                out[a][d] = total.to(self.devices[a][d])
        return out


def _check_axis(axis: str) -> None:
    if axis not in AXES:
        raise ValueError(f"axis must be one of {AXES}, got {axis!r}")


def make_mesh(n_amp: int = 1, n_dp: int = 1, devices=None) -> Mesh:
    """An (amp, dp) mesh of the first n_amp * n_dp devices: the host's
    CUDA devices, or the ``devices`` given (which may repeat one)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    need = n_amp * n_dp
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh([devices[a * n_dp:(a + 1) * n_dp] for a in range(n_amp)])
