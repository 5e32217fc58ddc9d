"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4, head 128)
d_ff(expert)=1536 vocab=151936, MoE 128 experts top-8, qk-norm.
[hf:Qwen/Qwen3-235B-A22B family; hf]"""

from ..models.layers import MoEConfig
from ..models.transformer import LMConfig
from .registry import ArchSpec, register, LM_SHAPES
from .lm_common import build_lm_cell, lm_smoke

FULL = LMConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,
    vocab_size=151936,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536, n_shared=0,
                  capacity_factor=1.25),
    rope_theta=1e6,
    qk_norm=True,
)

SMOKE = LMConfig(
    name="qwen3-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=96,
    vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=96, n_shared=0),
    qk_norm=True,
    dtype="float32",
)

register(ArchSpec(
    arch_id="qwen3-moe-235b-a22b",
    family="lm",
    shapes=LM_SHAPES,
    build_cell=lambda shape, **opts: build_lm_cell(FULL, shape, **opts),
    smoke_step=lambda device=None: lm_smoke(SMOKE, device),
    description=__doc__,
))
