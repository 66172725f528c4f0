"""The benchmark of the PyTorch and CUDA port (``fhe_gpt2_tpu_torch``).

``BENCHMARK.json`` at the root of the checkout names the cells; ``run.py``
runs one. The configurations (``configs/``), traffic mixes (``traffic/``),
request drivers (``drivers/``), metric readers (``metrics/``), the work
arithmetic (``work.py``) and the plain reference (``reference/``) live
here, apart from the program, which this package drives only through its
public entry points and never imports JAX or the JAX package.
"""
