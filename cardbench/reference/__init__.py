"""The plain reference that decides a run's ``correct``.

Plain PyTorch and NumPy, written from the upstream's definitions (the
mass-conservation residual with numpy-gradient differences, the Gaussian
mass-conservation loss, sklearn's normal-score transform, the block menu).
It imports nothing of the program, nor JAX: it reads the program's outputs
only to judge them.
"""
