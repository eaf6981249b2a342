"""Parallel proving: B proofs of one circuit at once (`batch.py`), and one
proof length-sharded over a mesh of ranks on torch.distributed (`mesh.py`,
`distributed.py`, `sharded.py`)."""
