"""fhe_gpt2_tpu_torch — the RNS-CKKS core of ``fhe_gpt2_tpu`` on PyTorch and CUDA.

A second package beside the JAX one, with the same module layout and public
names, so each module here has its counterpart under ``fhe_gpt2_tpu/core``.
It imports ``torch`` and numpy, never ``jax`` and nothing of ``fhe_gpt2_tpu``.

Conventions:
  * Residues are ``torch.int32`` tensors: every modulus is below 2**31, so a
    canonical residue in [0, q) fits without a sign. Shoup and Barrett
    constants (which may reach 2**32 - 1) keep their uint32 bit pattern in
    the same int32 storage; only the CUDA kernels read them.
  * The device of a tensor decides the route. A CUDA tensor goes through the
    hand-written kernels in ``csrc/`` (or the wrapper raises); a CPU tensor
    goes through the plain PyTorch version of the same function. Nothing
    falls back from one to the other.
  * ``CkksContext`` lives on ``"cuda"`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
