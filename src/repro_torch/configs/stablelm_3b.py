"""stablelm-3b [dense] — 32L d_model=2560 32H (MHA kv=32) d_ff=6912
vocab=50304.  [hf:stabilityai/stablelm family; unverified]"""

from ..models.transformer import LMConfig
from .registry import ArchSpec, register, LM_SHAPES
from .lm_common import build_lm_cell, lm_smoke

FULL = LMConfig(
    name="stablelm-3b",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=6912,
    vocab_size=50304,
    rope_theta=1e4,
)

SMOKE = LMConfig(
    name="stablelm-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=512,
    dtype="float32",
)

register(ArchSpec(
    arch_id="stablelm-3b",
    family="lm",
    shapes=LM_SHAPES,
    build_cell=lambda shape, **opts: build_lm_cell(FULL, shape, **opts),
    smoke_step=lambda device=None: lm_smoke(SMOKE, device),
    description=__doc__,
))
