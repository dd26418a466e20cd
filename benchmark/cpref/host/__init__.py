"""The reference's host layer: the fields and the curve on Python ints,
the transcript and the RNG, the codecs; the heavy point arithmetic and
the two permutations in `plain.c`."""

from . import field, g1, rng, serde, strobe  # noqa: F401
from .g1 import G1, GENERATOR, INFINITY  # noqa: F401
from .rng import StdRng  # noqa: F401
from .strobe import MerlinTranscript  # noqa: F401
