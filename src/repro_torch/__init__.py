"""PyTorch/CUDA port of the ERBIUM-style MCT rule engine (``repro``'s
counterpart, module for module). Imports torch and numpy, never JAX or the
``repro`` package. Entry points run on the card (``device="cuda"``) unless
the caller passes ``device="cpu"``, where the kernels' plain versions run."""
