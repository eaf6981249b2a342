"""Example circuits (examples.py) and the Poseidon hash with its circuit
generator (poseidon.py): the workloads of the tests and of chip_smoke.py."""
