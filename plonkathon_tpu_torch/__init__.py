"""plonkathon_tpu_torch — the PLONK prover on PyTorch and hand-written CUDA.

The port of `plonkathon_tpu` (JAX on a TPU) to an NVIDIA H100: the same
`Setup` / `Program` / `Prover` / `VerificationKey` surface and the same
proofs bit for bit.  Field and curve arithmetic run as batched limb tensors
in torch; the ten kernels that stand for the JAX package's Pallas calls
(Montgomery multiply, NTT butterflies, complete and incomplete point adds,
the msm2 and msm3 run-scans, repeated doubling) are CUDA C++ for sm_90a
under `csrc/`, built with nvcc at first use.  Small circuits commit through
msm2 and transform through the Stockham NTT; from 8192 coefficients and
n = 2^14 up the proving path takes msm3 and the four-step NTT.  Entry points run on
the card unless the caller passes `device="cpu"`, which runs the kernels'
plain torch versions.

Quick start::

    from plonkathon_tpu_torch import Setup, Program, Prover

    setup = Setup.from_file("powersOfTau28_hez_final_11.ptau")
    program = Program(["e public", "c <== a * b", "e <== c * d"], 8)
    proof = Prover(setup, program).prove({"a": 3, "b": 4, "c": 12, "d": 5, "e": 60})
    vk = setup.verification_key(program.common_preprocessed_input())
    assert vk.verify_proof(8, proof, [60])
"""

from .fields import Fr, Fq, Fq2, Fq12, Scalar, FR_MOD, FQ_MOD
from .poly import Polynomial, Basis
from .frontend import Program, CommonPreprocessedInput
from .kzg import Setup
from .prover import Prover, Proof
from .verifier import VerificationKey
from .transcript import (
    Transcript,
    Message1,
    Message2,
    Message3,
    Message4,
    Message5,
)
from .utils.serialization import interpret_json_point, load_proof_pickle

__version__ = "0.1.0"

__all__ = [
    "Fr",
    "Fq",
    "Fq2",
    "Fq12",
    "Scalar",
    "FR_MOD",
    "FQ_MOD",
    "Polynomial",
    "Basis",
    "Program",
    "CommonPreprocessedInput",
    "Setup",
    "Prover",
    "Proof",
    "VerificationKey",
    "Transcript",
    "Message1",
    "Message2",
    "Message3",
    "Message4",
    "Message5",
    "interpret_json_point",
    "load_proof_pickle",
]
