"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) d_ff(expert)=1408
vocab=102400, MoE 64 routed top-6 + 2 shared experts (fine-grained).
[arXiv:2401.06066; hf]  (The HF model's dense layer-0 FFN is simplified to
MoE-everywhere; noted in DESIGN.md §Arch-applicability.)"""

from ..models.layers import MoEConfig
from ..models.transformer import LMConfig
from .registry import ArchSpec, register, LM_SHAPES
from .lm_common import build_lm_cell, lm_smoke

FULL = LMConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  d_shared=1408, capacity_factor=1.25),
    rope_theta=1e4,
)

SMOKE = LMConfig(
    name="deepseek-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=96,
    vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=3, d_expert=64, n_shared=2, d_shared=64),
    dtype="float32",
)

register(ArchSpec(
    arch_id="deepseek-moe-16b",
    family="lm",
    shapes=LM_SHAPES,
    build_cell=lambda shape, **opts: build_lm_cell(FULL, shape, **opts),
    smoke_step=lambda device=None: lm_smoke(SMOKE, device),
    description=__doc__,
))
