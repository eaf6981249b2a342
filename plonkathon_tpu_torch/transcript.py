"""PLONK Fiat-Shamir transcript and the five prover message types.

Round schedule and byte formats match reference transcript.py:58-123 exactly
(32-byte big-endian scalars/coordinates, 255-byte challenges rejection-sampled
to be nonzero and re-absorbed).  Note: like the reference (prover.py:56), the
preprocessed key and public inputs are deliberately NOT absorbed — required
for bit-identical challenge streams.
"""

from __future__ import annotations

from dataclasses import dataclass

from .fields import Fr
from .merlin import MerlinTranscript


@dataclass
class Message1:
    a_1: tuple  # [a(x)]_1 — commitment to the left wire polynomial
    b_1: tuple  # [b(x)]_1 — commitment to the right wire polynomial
    c_1: tuple  # [c(x)]_1 — commitment to the output wire polynomial
    # PlonKup extension (None for vanilla circuits): query polynomial f and
    # the sorted-concatenation halves h1/h2 (see plonkup.py).
    f_1: tuple | None = None
    h1_1: tuple | None = None
    h2_1: tuple | None = None


@dataclass
class Message2:
    z_1: tuple  # [z(x)]_1 — commitment to the permutation grand product
    z2_1: tuple | None = None  # [z2(x)]_1 — lookup grand product (PlonKup)


@dataclass
class Message3:
    t_lo_1: tuple   # [t_lo(x)]_1 — low chunk of the quotient polynomial
    t_mid_1: tuple  # [t_mid(x)]_1 — middle chunk
    t_hi_1: tuple   # [t_hi(x)]_1 — high chunk


@dataclass
class Message4:
    a_eval: Fr          # a(zeta)
    b_eval: Fr          # b(zeta)
    c_eval: Fr          # c(zeta)
    s1_eval: Fr         # S_sigma1(zeta)
    s2_eval: Fr         # S_sigma2(zeta)
    z_shifted_eval: Fr  # z(zeta * omega)
    # PlonKup extension (None for vanilla circuits): openings of f, t, h1,
    # h2 at zeta and of t, h1, h2, z2 at zeta*omega (plonkup.EVAL_ORDER).
    lookup_evals: dict | None = None


@dataclass
class Message5:
    W_z_1: tuple   # [W_zeta(x)]_1 — opening proof at zeta
    W_zw_1: tuple  # [W_zeta_omega(x)]_1 — opening proof at zeta*omega


class Transcript(MerlinTranscript):
    def append(self, label: bytes, item: bytes) -> None:
        self.append_message(label, item)

    def append_scalar(self, label: bytes, item) -> None:
        self.append_message(label, int(item).to_bytes(32, "big"))

    def append_point(self, label: bytes, item) -> None:
        self.append_message(label, int(item[0]).to_bytes(32, "big"))
        self.append_message(label, int(item[1]).to_bytes(32, "big"))

    def get_and_append_challenge(self, label: bytes) -> Fr:
        while True:
            challenge_bytes = self.challenge_bytes(label, 255)
            f = Fr(int.from_bytes(challenge_bytes, "big"))
            if f != Fr.zero():
                self.append(label, challenge_bytes)
                return f

    def round_1(self, message: Message1) -> tuple[Fr, Fr]:
        self.append_point(b"a_1", message.a_1)
        self.append_point(b"b_1", message.b_1)
        self.append_point(b"c_1", message.c_1)
        if message.f_1 is not None:
            # PlonKup: absorb the lookup commitments BEFORE any challenge,
            # then draw the dedicated lookup challenges delta/epsilon
            # (stashed as attributes; vanilla circuits never reach this, so
            # their challenge stream — and proof bit-identity — is intact).
            self.append_point(b"f_1", message.f_1)
            self.append_point(b"h1_1", message.h1_1)
            self.append_point(b"h2_1", message.h2_1)
        beta = self.get_and_append_challenge(b"beta")
        gamma = self.get_and_append_challenge(b"gamma")
        if message.f_1 is not None:
            self.delta = self.get_and_append_challenge(b"delta")
            self.epsilon = self.get_and_append_challenge(b"epsilon")
        return beta, gamma

    def round_2(self, message: Message2) -> tuple[Fr, Fr]:
        self.append_point(b"z_1", message.z_1)
        if message.z2_1 is not None:
            self.append_point(b"z2_1", message.z2_1)
        alpha = self.get_and_append_challenge(b"alpha")
        # Unpredictable coset shift for the 4n evaluation domain; keeps the
        # quotient division denominators nonzero.
        fft_cofactor = self.get_and_append_challenge(b"fft_cofactor")
        return alpha, fft_cofactor

    def round_3(self, message: Message3) -> Fr:
        self.append_point(b"t_lo_1", message.t_lo_1)
        self.append_point(b"t_mid_1", message.t_mid_1)
        self.append_point(b"t_hi_1", message.t_hi_1)
        return self.get_and_append_challenge(b"zeta")

    def round_4(self, message: Message4) -> Fr:
        self.append_scalar(b"a_eval", message.a_eval)
        self.append_scalar(b"b_eval", message.b_eval)
        self.append_scalar(b"c_eval", message.c_eval)
        self.append_scalar(b"s1_eval", message.s1_eval)
        self.append_scalar(b"s2_eval", message.s2_eval)
        self.append_scalar(b"z_shifted_eval", message.z_shifted_eval)
        if message.lookup_evals is not None:
            from .plonkup import EVAL_ORDER

            for k in EVAL_ORDER:
                self.append_scalar(k.encode(), message.lookup_evals[k])
        return self.get_and_append_challenge(b"v")

    def round_5(self, message: Message5) -> Fr:
        self.append_point(b"W_z_1", message.W_z_1)
        self.append_point(b"W_zw_1", message.W_zw_1)
        return self.get_and_append_challenge(b"u")
