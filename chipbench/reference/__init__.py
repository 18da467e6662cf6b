"""The plain reference: each configuration's forward pass in plain PyTorch,
float32, with TF32 off, from the published equations.

It imports nothing of the program under test (neither ``repro_torch`` nor
the JAX package) and takes nothing the program made: it reads the raw
weights that ``chipbench.weights`` draws from the seed, the same tensors
that are handed to the program, and works out every cast again.

``model.py`` holds what every configuration has (the embedding, the final
norm, the head) and runs the layers; each block kind has a module of its
own here (``dense.py``, ``mamba.py``), found by the kind's name, that lists
its weights and computes one layer. ``precision.py`` holds the two ways a
product is taken: exactly (float32) or, for the control, in fp8.
"""
