"""Hand-written CUDA kernels of the port and their plain versions.

    batched_onestep_decode      dense one-step decode over a mask batch
    batched_onestep_decode_ell  the same via the row-ELL packing of G
    coded_accumulate_batched    weights @ worker messages
    fused_decode_apply          diag(scales) masks @ worker messages

Call them through ``kernels.ops``, which sends CPU tensors to the plain
versions in ``kernels.ref`` and CUDA tensors to the kernels (built from
``csrc/`` by ``kernels.cuda`` at first use).
"""

from . import ops  # noqa: F401
from . import ref  # noqa: F401
