"""PyTorch/CUDA port of the approximate-gradient-coding system.

Mirrors the layout of the JAX package ``repro`` (``core/``, ``runtime/``,
``sim/``, ``dist/``, ``kernels/``) and imports none of it.  That package
is "the reference" throughout these docstrings: the tests hold every
module here against its counterpart there.  Codes, masks and traces
are numpy arrays drawn from ``np.random.default_rng`` exactly as there, so
both packages see the same codes and masks from the same seed; the decode
and the gradient aggregation run on tensors, through hand-written CUDA
kernels on the card (``kernels/``, sources in ``csrc/``) or their plain
PyTorch versions when the caller asks for ``device="cpu"``.

Entry points run on the GPU unless the caller asks for the CPU
(``platform.device``); nothing picks the CPU by itself.
"""

from . import platform  # noqa: F401
