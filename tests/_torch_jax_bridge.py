"""Hand the port's verification keys and proofs to the JAX package's host
verifier, by integer coordinates and scalars (the two packages' field
classes differ)."""

from plonkathon_tpu import prover as jax_prover
from plonkathon_tpu import transcript as jax_transcript
from plonkathon_tpu import verifier as jax_verifier
from plonkathon_tpu.fields import Fq as JaxFq
from plonkathon_tpu.fields import Fq2 as JaxFq2
from plonkathon_tpu.fields import Fr as JaxFr

G1_KEYS = ("Qm", "Ql", "Qr", "Qo", "Qc", "S1", "S2", "S3")


def jax_g1(pt):
    return None if pt is None else (JaxFq(int(pt[0])), JaxFq(int(pt[1])))


def jax_g2(pt):
    return tuple(JaxFq2(list(c.coeffs)) for c in pt)


def jax_vk(vk):
    """The JAX package's VerificationKey with the port key's points."""
    return jax_verifier.VerificationKey(
        vk.group_order,
        *(jax_g1(getattr(vk, k)) for k in G1_KEYS),
        jax_g2(vk.X_2),
        JaxFr(int(vk.w)),
        Qcube=jax_g1(vk.Qcube), Qk=jax_g1(vk.Qk), Tbl=jax_g1(vk.Tbl),
        t_last=None if vk.t_last is None else JaxFr(int(vk.t_last)),
    )


def jax_proof(proof):
    """The JAX package's Proof with the port proof's fields."""
    m1, m2, m3, m4, m5 = (proof.msg_1, proof.msg_2, proof.msg_3, proof.msg_4, proof.msg_5)
    T = jax_transcript
    lk = m4.lookup_evals
    return jax_prover.Proof(
        T.Message1(*(jax_g1(p) for p in (m1.a_1, m1.b_1, m1.c_1, m1.f_1, m1.h1_1, m1.h2_1))),
        T.Message2(jax_g1(m2.z_1), jax_g1(m2.z2_1)),
        T.Message3(*(jax_g1(p) for p in (m3.t_lo_1, m3.t_mid_1, m3.t_hi_1))),
        T.Message4(
            *(JaxFr(int(getattr(m4, k))) for k in (
                "a_eval", "b_eval", "c_eval", "s1_eval", "s2_eval", "z_shifted_eval")),
            lookup_evals=None if lk is None else {k: JaxFr(int(v)) for k, v in lk.items()},
        ),
        T.Message5(jax_g1(m5.W_z_1), jax_g1(m5.W_zw_1)),
    )


def ints(v):
    """A proof field as ints (a point as its coordinate pair)."""
    return tuple(int(c) for c in v) if isinstance(v, tuple) else int(v)
