"""AI21-Jamba2-Mini — Mamba1, GQA attention and MoE layers interleaved.
[hf:ai21labs/AI21-Jamba2-Mini]

32 layers of d 4096: attention (32/8 heads of 128, no positional
encoding) at layers 4, 12, 20 and 28, Mamba1 (d_inner 8192, state 16,
dt rank 256, conv 4 with a bias, RMSNorms on dt, B and C) elsewhere; a
MoE feed-forward on odd layers (16 experts of width 14336, top 2, the
softmax's weights not renormalised) and a dense SwiGLU of that width on
even ones; vocab 65536, head untied.

``CONFIG`` is one card's share of expert parallelism over two cards:
every layer at its published width, each MoE layer's router over all 16
experts, experts 0-7 held here.  Served by ``engine/runner.py:
PagedRunner`` (paged KV for the attention layers, a Mamba state per
slot); not in ``ARCH_IDS``, whose entries the dry-run holds to the JAX
package, which has no Jamba.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba2-mini", arch_type="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536, rope_theta=0.0, rmsnorm_eps=1e-6,
    num_experts=8, router_experts=16, expert_offset=0, experts_per_token=2,
    renormalize_topk=False,
    ssm_state=16, ssm_version=1, ssm_expand=2, ssm_conv=4, ssm_dt_norms=True,
    attn_layer_period=8, attn_layer_offset=4,
    expert_layer_period=2, expert_layer_offset=1,
    source="hf:ai21labs/AI21-Jamba2-Mini",
)

# one whole period (8 layers: attention at 4, MoE on odd layers), the
# router at twice the experts held
SMOKE_CONFIG = CONFIG.replace(
    name="jamba2-mini-smoke", num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=96, vocab_size=256, num_experts=4, router_experts=8,
    ssm_state=8,
)
