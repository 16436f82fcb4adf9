"""Training-evidence tools (torch counterparts of the JAX package's
``tools/train_convergence.py`` and ``tools/train_generalization.py``)."""
