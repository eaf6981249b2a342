"""Hygiene of the port package (CPU).

* It imports no JAX and nothing of plonkathon_tpu, in any submodule.
* Its entry points run on the card unless the caller asks for the CPU:
  without a card, asking for CUDA (the default) raises.
* chip_smoke.py's per-phase required kernel sets together name every
  kernel that counts launches.
"""

import os
import subprocess
import sys

import pytest
import torch

from plonkathon_tpu_torch import Program, Prover, Setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PTAU = os.path.join(ROOT, "tests", "fixtures", "powersOfTau28_hez_final_11.ptau")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import plonkathon_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] == "jax" or n.split(".")[0].startswith("jax")
             or n == "plonkathon_tpu" or n.startswith("plonkathon_tpu."))
print("IMPORTED", len([n for n in sys.modules if n.startswith("plonkathon_tpu_torch")]))
print("BAD", bad)
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    assert "BAD []" in out, out
    assert int(out.split("IMPORTED ")[1].split()[0]) >= 22, out
    for module in ("ops.msm3", "ops.ntt_fourstep"):
        assert os.path.exists(
            os.path.join(ROOT, "plonkathon_tpu_torch", *module.split(".")) + ".py")


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's module level and its port imports pull in no JAX, and
    its per-phase required sets leave no launch-counting kernel unnamed."""
    code = (
        "import sys; sys.path.insert(0, '.'); import chip_smoke, "
        "plonkathon_tpu_torch.ops.cuda_lib as lib, plonkathon_tpu_torch.ops.msm2, "
        "plonkathon_tpu_torch.ops.msm3, plonkathon_tpu_torch.ops.ntt_fourstep; "
        "print(sorted(n for n in sys.modules if n.startswith('jax') "
        "or n.startswith('plonkathon_tpu.') or n == 'plonkathon_tpu')); "
        "named = set().union(*chip_smoke.REQUIRED.values()); "
        "print(sorted(set(lib.LAUNCHES) - named), sorted(named - set(lib.LAUNCHES))); "
        "print(sorted(set(lib.LAUNCHES) - set().union(*(v for k, v in "
        "chip_smoke.REQUIRED.items() if k != 'kernels'))))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.splitlines()
    assert out[0] == "[]", out
    assert out[1] == "[] []", out  # every id is required somewhere, none unknown
    # Outside the kernel-vs-plain phase only the caller-less kernels are
    # unnamed (K8a's elementwise add; its window sum is on the path).
    assert out[2] == "['K8a add', 'K8b', 'K9']", out


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")


def test_setup_defaults_to_cuda_and_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Setup.from_file(PTAU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Setup.generate(16)


def test_program_and_prover_default_to_cuda(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Program(["c <== a * b"], 8)
    setup = Setup.from_file(PTAU, device="cpu")
    program = Program(["c <== a * b"], 8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prover(setup, program)


def test_chip_smoke_refuses_without_a_card(no_card):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_prover_rejects_mixed_devices():
    setup = Setup.from_file(PTAU, device="cpu")
    program = Program(["c <== a * b"], 8, device="cpu")
    with pytest.raises(ValueError):
        Prover(setup, program, device="meta")
