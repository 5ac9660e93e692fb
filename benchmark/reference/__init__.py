"""The plain reference that decides ``correct``: a MADE autoregressive
neural quantum state (``ansatz.py``), sample-aware local energies of a
grouped Pauli Hamiltonian read from the molecule's npz file
(``hamiltonian.py``), and the VMC update -- Born estimators, the REINFORCE
surrogate loss, MinSR, the global-norm clip and Adam (``vmc.py``).

It is written from the method's description in plain PyTorch and NumPy, and
imports nothing of the program under test (nor JAX): the benchmark hands it
the same raw inputs it hands the program (the npz file, the initial
weights) and the program's outputs to judge.
"""
