"""distel_tpu_torch — the EL+ classifier on PyTorch and CUDA.

The port of ``distel_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper card.  It keeps the reference package's module paths and class
names, so each module has an obvious counterpart there:

=========  ================================  ==============================
Layer      Module                            What runs there
=========  ================================  ==============================
frontend   ``owl``, ``frontend``             OFN parsing, normalization
indexing   ``core.indexing``                 integer tensors of the corpus
engine     ``core.rowpacked_engine``         the saturation fixed point
kernels    ``ops.bitmatmul`` (+ ``csrc/``)   packed-columns AND-OR product
runtime    ``runtime``                       classify, taxonomy, snapshots
=========  ================================  ==============================

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
