"""The PyTorch port imports neither JAX nor the JAX package: a fresh
interpreter imports every module of ``tensorrl_qas_tpu_torch`` and finds
no ``jax``, ``flax``, ``optax`` or ``tensorrl_qas_tpu`` in sys.modules.
Importing also builds nothing: no kernel library appears."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = """
import importlib, pkgutil, sys
import tensorrl_qas_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
banned = ("jax", "jaxlib", "flax", "optax", "tensorrl_qas_tpu")
found = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), "modules;", "banned:", found)
assert not found, found
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "banned: []" in proc.stdout
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke run exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "",
                               "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_tape_kernels_module_builds_nothing_at_import():
    """The composed engine's kernel module (``ops/apply_tape.py``) imports
    without JAX and without building or loading its library; its plain
    versions and autograd Function are there, its launch counts at 0."""
    script = """
import sys
from tensorrl_qas_tpu_torch.ops import apply_tape as at
from tensorrl_qas_tpu_torch.optim import angle_opt
assert at._library.cache_info().currsize == 0
assert at._sweep_library.cache_info().currsize == 0
assert (at.apply_tape_fwd.launches, at.apply_tape_bwd.launches) == (0, 0)
assert (at.apply_tape_fwd.sweep_launches,
        at.apply_tape_bwd.sweep_launches) == (0, 0)
assert callable(at.apply_tape_fwd_plain) and callable(at.apply_tape_bwd_plain)
assert hasattr(angle_opt, "composed_step") and at.MAX_QUBITS == 20
banned = ("jax", "jaxlib", "tensorrl_qas_tpu", "triton")
found = sorted(m for m in sys.modules if m.split(".")[0] in banned)
assert not found, found
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"


def test_sequential_modules_import_without_jax_or_a_build():
    """The sequential trainer's modules (``native``, ``train/driver.py``,
    the CLI) import without JAX and without building or loading csim;
    the port keeps its own copy of csim's source."""
    script = """
import sys
from tensorrl_qas_tpu_torch import native
from tensorrl_qas_tpu_torch.train import cli, driver
from tensorrl_qas_tpu_torch.agents.replay import PrioritizedReplayMemory
from tensorrl_qas_tpu_torch.ops.build import CSRC, host_library_path
assert native._library.cache_info().currsize == 0
assert callable(driver.train) and callable(cli.run)
assert (CSRC / "csim.cpp").exists()
assert CSRC.parent.name == "tensorrl_qas_tpu_torch"
assert host_library_path("csim").parent.name == "build"
banned = ("jax", "jaxlib", "flax", "optax", "tensorrl_qas_tpu", "scipy")
found = sorted(m for m in sys.modules if m.split(".")[0] in banned)
assert not found, found
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"


def test_sharded_modules_import_without_jax():
    """The multi-device modules (``parallel/``, ``optim/sharded_opt.py``)
    import without JAX and without touching a card; a mesh of repeated
    CPU devices needs none."""
    script = """
import sys
import torch
from tensorrl_qas_tpu_torch.parallel.mesh import Mesh, make_mesh
from tensorrl_qas_tpu_torch.parallel.sharded_sim import (
    ShardedSimulator, shard_state, unshard_state)
from tensorrl_qas_tpu_torch.parallel.dryrun import dryrun_multichip
from tensorrl_qas_tpu_torch.optim.sharded_opt import ShardedAngleOptimizer
from tensorrl_qas_tpu_torch.envs.circuit_env import EnvConfig
assert EnvConfig.__dataclass_fields__["mesh_shape"].default is None
assert EnvConfig.__dataclass_fields__["mesh_devices"].default is None
mesh = make_mesh(2, 4, ["cpu"] * 8)
assert isinstance(mesh, Mesh) and mesh.lead == torch.device("cpu")
assert callable(dryrun_multichip) and callable(shard_state)
assert not torch.cuda.is_initialized()
banned = ("jax", "jaxlib", "flax", "optax", "tensorrl_qas_tpu")
found = sorted(m for m in sys.modules if m.split(".")[0] in banned)
assert not found, found
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"
