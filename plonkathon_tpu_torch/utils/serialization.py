"""Serialization compatibility with the reference ecosystem.

* `load_proof_pickle` reads proof pickles produced by the reference stack
  (module paths `prover.Proof`, `transcript.Message1..5`, `curve.Scalar`,
  `py_ecc.fields.bn128_FQ`, cf. test/proof.pickle) by remapping class paths
  onto this framework's types.
* `interpret_json_point` decodes zkrepl/snarkjs projective JSON points
  (reference utils.py:10-22 semantics).
"""

from __future__ import annotations

import io
import pickle

from ..fields import Fq, Fq2, Fr

_CLASS_MAP = {
    ("prover", "Proof"): ("plonkathon_tpu_torch.prover", "Proof"),
    ("transcript", "Message1"): ("plonkathon_tpu_torch.transcript", "Message1"),
    ("transcript", "Message2"): ("plonkathon_tpu_torch.transcript", "Message2"),
    ("transcript", "Message3"): ("plonkathon_tpu_torch.transcript", "Message3"),
    ("transcript", "Message4"): ("plonkathon_tpu_torch.transcript", "Message4"),
    ("transcript", "Message5"): ("plonkathon_tpu_torch.transcript", "Message5"),
    ("curve", "Scalar"): ("plonkathon_tpu_torch.fields", "Fr"),
    ("py_ecc.fields", "bn128_FQ"): ("plonkathon_tpu_torch.fields", "Fq"),
    ("py_ecc.fields.field_elements", "FQ"): ("plonkathon_tpu_torch.fields", "Fq"),
}


class _RemappingUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        mapped = _CLASS_MAP.get((module, name))
        if mapped is not None:
            module, name = mapped
        if not module.startswith(("plonkathon_tpu_torch", "builtins")):
            raise pickle.UnpicklingError(
                f"refusing to unpickle foreign class {module}.{name}"
            )
        return super().find_class(module, name)


def load_proof_pickle(path_or_bytes):
    """Load a reference-format proof pickle into this framework's Proof."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        stream = io.BytesIO(path_or_bytes)
        return _RemappingUnpickler(stream).load()
    with open(path_or_bytes, "rb") as f:
        return _RemappingUnpickler(f).load()


def interpret_json_point(p):
    """Decode a zkrepl/snarkjs projective JSON point to host affine form."""
    if len(p) == 3 and isinstance(p[0], str) and p[2] == "1":
        return (Fq(int(p[0])), Fq(int(p[1])))
    if len(p) == 3 and p == ["0", "1", "0"]:
        return None  # G1 identity
    if len(p) == 3 and isinstance(p[0], list) and p[2] == ["1", "0"]:
        return (
            Fq2([int(p[0][0]), int(p[0][1])]),
            Fq2([int(p[1][0]), int(p[1][1])]),
        )
    if len(p) == 3 and p == [["0", "0"], ["1", "0"], ["0", "0"]]:
        return None  # G2 identity
    raise ValueError(f"cannot interpret point: {p}")
