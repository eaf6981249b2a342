"""Plain reference for the benchmark's `correct`: Python integers only.

It imports nothing of the program under test and nothing of JAX.  Given a
circuit's source lines, its inputs and the SRS trapdoor tau (all drawn by
the benchmark from the seed), it works out every value a proof must hold
and judges a proof, handed over as plain integers, against them.
"""
