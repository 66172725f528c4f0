"""fhe_gpt2_tpu_torch — ``fhe_gpt2_tpu`` on PyTorch and CUDA.

A second package beside the JAX one, with the same module layout and public
names, so each module here has its counterpart under ``fhe_gpt2_tpu/``
(``core/``, ``approx/``, ``nn/``, ``boot/``, ``cnn/``, ``net/``,
``utils/``, ``run_resnet.py``, ``run_gpt2.py``).
It imports ``torch`` and numpy, never ``jax`` and nothing of ``fhe_gpt2_tpu``.

Conventions:
  * The modulus chain picks the word, as in the JAX package. Where every
    modulus is below 2**31, residues are ``torch.int32`` tensors (a
    canonical residue in [0, q) fits without a sign; Shoup and Barrett
    constants keep their uint32 bit pattern in the same storage). Otherwise
    (the u64 engine, moduli below 2**62) they are ``torch.int64`` tensors
    holding uint64 bits, and no int64 op relies on overflow wrapping
    (``core/modmath.py``).
  * The word, then the device, decides the route. An int32 CUDA tensor goes
    through the hand-written kernels in ``csrc/`` (or the wrapper raises);
    an int32 CPU tensor, and an int64 tensor on any device, go through the
    plain PyTorch version of the same function. Nothing falls back from one
    to the other.
  * ``CkksContext`` lives on ``"cuda"`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
