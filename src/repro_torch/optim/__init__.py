"""AdamW with its schedules and int8 gradient compression, as
``repro.optim``."""

from .adamw import (AdamWState, adamw_init, adamw_state_from_numpy,  # noqa: F401
                    adamw_update, global_norm)
from .schedule import cosine_schedule, linear_warmup  # noqa: F401
from .compression import (  # noqa: F401
    CompressionState, compress_int8, compressed_gradient, compression_init,
    decompress_int8,
)
