"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000, llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""

from ..models.transformer import LMConfig
from .registry import ArchSpec, register, LM_SHAPES
from .lm_common import build_lm_cell, lm_smoke

FULL = LMConfig(
    name="h2o-danube-3-4b",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_head=120,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1e4,
)

SMOKE = LMConfig(
    name="h2o-danube3-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=160,
    vocab_size=512,
    sliding_window=8,
    dtype="float32",
)

register(ArchSpec(
    arch_id="h2o-danube-3-4b",
    family="lm",
    shapes=LM_SHAPES,
    build_cell=lambda shape, **opts: build_lm_cell(FULL, shape, **opts),
    smoke_step=lambda device=None: lm_smoke(SMOKE, device),
    description=__doc__,
))
