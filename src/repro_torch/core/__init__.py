"""Core library of the port: gradient-code constructions, decoders,
the scheme registry, the batched DecodeEngine and the Monte-Carlo
simulation engine (see the JAX package's ``core`` for the same names)."""

from .codes import (  # noqa: F401
    CODE_REGISTRY,
    GradientCode,
    bgc,
    cyclic_repetition,
    frc,
    make_code,
    rbgc,
    spectral_gap,
    sregular,
    uncoded,
)
from .assignment import CodedAssignment, build_assignment  # noqa: F401
from .engine import BatchDecode, DecodeEngine  # noqa: F401
from .registry import CodeFamily  # noqa: F401
from . import adversary, decoding, registry, simulate, theory  # noqa: F401
