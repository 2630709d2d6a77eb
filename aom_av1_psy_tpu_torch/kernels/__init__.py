"""Build and binding of the hand-written CUDA kernels (see ``build.py``)."""
