"""Parallel proving: B proofs of one circuit at once (`batch.py`)."""
