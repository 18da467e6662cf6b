"""PyTorch/CUDA port of the ``repro`` serving path.

Imports torch and numpy only, never jax and nothing of ``repro``: what it
needs of the reference's plain-Python modules it carries as its own copy.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
