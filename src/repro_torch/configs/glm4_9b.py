"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552, RoPE.  [hf:THUDM/glm-4-9b; hf]"""

from ..models.transformer import LMConfig
from .registry import ArchSpec, register, LM_SHAPES
from .lm_common import build_lm_cell, lm_smoke

FULL = LMConfig(
    name="glm4-9b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_head=128,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=1e4,
)

SMOKE = LMConfig(
    name="glm4-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=192,
    vocab_size=512,
    dtype="float32",
)

register(ArchSpec(
    arch_id="glm4-9b",
    family="lm",
    shapes=LM_SHAPES,
    build_cell=lambda shape, **opts: build_lm_cell(FULL, shape, **opts),
    smoke_step=lambda device=None: lm_smoke(SMOKE, device),
    description=__doc__,
))
