"""Config system: model architecture configs and input-shape configs.

Every assigned architecture gets a module ``src/repro_torch/configs/<id>.py``
exporting ``CONFIG`` (full size, dry-run only) and ``SMOKE_CONFIG``
(reduced: <=2 layers, d_model<=512, <=4 experts, runnable on CPU).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional

# Layer kind codes (per-layer layout string):
#   'A' = attention + MLP transformer block (dense / moe decided by cfg)
#   'M' = Mamba block (version per cfg.ssm_version)
#   'S' = shared-attention block boundary (zamba2: one globally shared
#         attention+MLP block applied between groups of Mamba layers)
LAYER_ATTN = "A"
LAYER_MAMBA = "M"
LAYER_SHARED = "S"


@dataclass(frozen=True)
class ModelConfig:
    """Architecture config covering dense / moe / ssm / hybrid / audio / vlm."""

    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                    # query heads ('A' layers); 0 for attn-free
    num_kv_heads: int
    d_ff: int                         # dense-MLP hidden dim (per-expert dim if MoE)
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = False
    # Attention variant: "full" | "swa". sliding_window used when "swa".
    attn_variant: str = "full"
    sliding_window: int = 0
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    router_aux_coef: float = 0.01
    # expert capacity = ceil(T*k/E * capacity_factor); tokens overflowing an
    # expert's capacity are dropped (standard GShard/Switch semantics).
    # Set large (e.g. 1e9) to make routing lossless for exactness tests.
    capacity_factor: float = 1.25
    # SSM (mamba)
    ssm_state: int = 0
    ssm_version: int = 1              # 1 = Mamba1 (falcon-mamba), 2 = Mamba2 (zamba2)
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_heads: int = 0                # mamba2 heads (d_inner // mamba2_head_dim)
    # Hybrid (zamba2): a shared attention block every `shared_attn_every`
    # Mamba layers, using ONE shared parameter set.
    shared_attn_every: int = 0
    # Decode KV-cache storage dtype: "" = model dtype; "int8" = quantized
    # per-(token, head) with f32 scales (vLLM-style fp8/int8 KV cache).
    kv_cache_dtype: str = ""
    # Encoder-only (hubert): bidirectional attention, no decode step.
    is_encoder: bool = False
    # Modality of the token stream. "text" and "vq_image+text" consume int32
    # token ids; "audio_frames" consumes precomputed float frame embeddings
    # (the conv feature extractor is a stub per assignment).
    modality: str = "text"
    dtype: str = "bfloat16"
    # provenance (source paper / model card for the config numbers)
    source: str = ""

    # Settings the JAX package's configuration has no field for (it lays out
    # none of the models that need them): ``ExtendedModelConfig``'s fields,
    # at the values that leave every other model as it is.  ``ModelConfig``
    # given any of them builds an ``ExtendedModelConfig``, so a plain
    # configuration's ``dataclasses.asdict`` stays the JAX package's.
    attn_layer_period = 0
    attn_layer_offset = 0
    expert_layer_period = 0
    expert_layer_offset = 0
    router_experts = 0
    expert_offset = 0
    renormalize_topk = True
    ssm_dt_norms = False

    def __new__(cls, *args, **kw):
        if cls is ModelConfig and _EXTENDED.intersection(kw):
            cls = ExtendedModelConfig
        return super().__new__(cls)

    # ---- derived ----
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attn_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def interleaved(self) -> bool:
        """Attention and Mamba1 mixers in one stack, by attn_layer_period."""
        return self.attn_layer_period > 0

    @property
    def has_mamba(self) -> bool:
        """Whether any layer keeps a recurrent state (Mamba1 or Mamba2)."""
        return LAYER_MAMBA in self.layer_layout

    @property
    def router_width(self) -> int:
        """The experts the router scores (all of them, held here or not)."""
        return self.router_experts or self.num_experts

    def is_moe_layer(self, i: int) -> bool:
        """Whether layer i's feed-forward is the MoE."""
        if not self.is_moe:
            return False
        p = self.expert_layer_period
        return not p or i % p == self.expert_layer_offset

    @property
    def layer_layout(self) -> str:
        """Per-layer kind string of length num_layers."""
        if self.interleaved:
            p, o = self.attn_layer_period, self.attn_layer_offset
            return "".join(LAYER_ATTN if i % p == o else LAYER_MAMBA
                           for i in range(self.num_layers))
        if self.arch_type == "ssm":
            return LAYER_MAMBA * self.num_layers
        if self.arch_type == "hybrid":
            # groups of `shared_attn_every` mamba layers; the shared attention
            # block is applied between groups (not counted as a layer).
            return LAYER_MAMBA * self.num_layers
        return LAYER_ATTN * self.num_layers

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d = self.d_model
        n = 0
        # embeddings (+ untied head)
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.interleaved:
            # counted whole: each layer's two norm scales, a Mamba layer's
            # conv bias, and the final norm's scale
            for i, kind in enumerate(self.layer_layout):
                n += (self._attn_params() if kind == LAYER_ATTN
                      else self._mamba_params() + self.d_inner)
                n += self._mlp_params() if self.is_moe_layer(i) else 3 * d * self.d_ff
            return n + (2 * self.num_layers + 1) * d
        for kind in self.layer_layout:
            if kind == LAYER_ATTN:
                n += self._attn_params() + self._mlp_params()
            elif kind == LAYER_MAMBA:
                n += self._mamba_params()
        if self.arch_type == "hybrid" and self.shared_attn_every:
            n += self._attn_params() + self._mlp_params()  # one shared block
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: only top-k experts; of a share of
        the experts, as if the token's top k were all held here)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        per_expert = 3 * d * self.d_ff
        total = self.param_count()
        moe_layers = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        inactive = (self.num_experts - self.experts_per_token) * per_expert * moe_layers
        return total - inactive

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        return d * nq * hd + 2 * d * nkv * hd + nq * hd * d + (
            (nq + 2 * nkv) * hd if self.qkv_bias else 0)

    def _mlp_params(self) -> int:
        if self.is_moe:
            d = self.d_model
            return self.num_experts * 3 * d * self.d_ff + d * self.router_width
        return 3 * self.d_model * self.d_ff

    def _mamba_params(self) -> int:
        d, di, s = self.d_model, self.d_inner, self.ssm_state
        if self.ssm_version == 1:
            dt_rank = max(1, d // 16)
            n = (d * 2 * di               # in_proj
                 + di * self.ssm_conv     # conv1d
                 + di * (dt_rank + 2 * s)  # x_proj
                 + dt_rank * di + di      # dt_proj
                 + di * s + di            # A_log, D
                 + di * d)                # out_proj
            if self.ssm_dt_norms:         # the dt, B and C norms' scales
                n += dt_rank + 2 * s
            return n
        # mamba2: in_proj -> [z, x, B, C, dt]
        nh = self.ssm_heads or max(1, di // 64)
        d_in_proj = 2 * di + 2 * s + nh
        return (d * d_in_proj + (di + 2 * s) * self.ssm_conv
                + nh * 3                  # A_log, D, dt_bias per head
                + di * d)


@dataclass(frozen=True)
class ExtendedModelConfig(ModelConfig):
    """A ``ModelConfig`` with settings the JAX package's has no field for."""

    # Layers of interleaved kinds (Jamba), served by engine/runner.py's
    # PagedRunner: with a period, layer i's mixer is attention where
    # i % attn_layer_period == attn_layer_offset and a Mamba1 layer
    # elsewhere, and (a MoE) its feed-forward is the MoE where
    # i % expert_layer_period == expert_layer_offset and a dense MLP
    # elsewhere.  0: every layer's mixer is attention and every
    # feed-forward as arch_type says.
    attn_layer_period: int = 0
    attn_layer_offset: int = 0
    expert_layer_period: int = 0
    expert_layer_offset: int = 0
    # Expert parallelism's share on this card: the router scores
    # router_experts experts (0: num_experts), of which this card holds
    # num_experts, those from expert_offset on, and computes their part.
    router_experts: int = 0
    expert_offset: int = 0
    # top-k weights renormalised to sum to one (Mixtral, Qwen3); Jamba
    # keeps them as the softmax over all experts gives them
    renormalize_topk: bool = True
    # Mamba1 (Jamba): RMSNorms on dt (before dt_proj), B and C after x_proj
    ssm_dt_norms: bool = False


_EXTENDED = frozenset(f.name for f in dataclasses.fields(ExtendedModelConfig)) - frozenset(
    f.name for f in dataclasses.fields(ModelConfig))


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "qwen2_5_14b",
    "internlm2_1_8b",
    "qwen3_moe_30b_a3b",
    "zamba2_2_7b",
    "starcoder2_7b",
    "mixtral_8x7b",
    "qwen1_5_4b",
    "hubert_xlarge",
    "falcon_mamba_7b",
    "chameleon_34b",
]

# CLI ids (hyphens) -> module names
ARCH_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ARCH_ALIASES.update({
    "qwen2.5-14b": "qwen2_5_14b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "starcoder2-7b": "starcoder2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen1.5-4b": "qwen1_5_4b",
    "hubert-xlarge": "hubert_xlarge",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "chameleon-34b": "chameleon_34b",
})


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod_name = ARCH_ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def shape_skips(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Return a skip-reason string if this (arch, shape) pair is skipped."""
    if cfg.is_encoder and shape.kind == "decode":
        return "encoder-only arch has no decode step (DESIGN.md §4)"
    return None


def variant_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Adjust the config for a shape (e.g. SWA for 500k full-attention archs)."""
    if shape.name == "long_500k" and not cfg.is_attn_free:
        if cfg.attn_variant != "swa" and cfg.arch_type != "hybrid":
            # dense/moe/vlm full-attention archs run long_500k as the
            # documented sliding-window variant (DESIGN.md §4).
            return cfg.replace(attn_variant="swa", sliding_window=8192)
        if cfg.arch_type == "hybrid":
            return cfg.replace(attn_variant="swa", sliding_window=4096)
    return cfg
