"""CRC-32 of a buffer on the card: the CUDA kernel and its wrappers
(``ops``) and the plain torch version with the host arithmetic both share
(``ref``).  It replaces no TPU kernel: ``core.tiered`` checks each streamed
shard with it after its copy, where the reference runs the host's zlib."""

from .ops import crc32, crc32_async  # noqa: F401
from .ref import crc32_ref  # noqa: F401
