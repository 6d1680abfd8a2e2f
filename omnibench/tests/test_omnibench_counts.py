"""The FLOP and byte counts against counts made by hand."""
import pytest

from omnibench import counts, spec

SMOKE = dict(d_model=4, num_layers=1, num_heads=2, num_kv_heads=1, head_dim=2, d_ff=3,
             vocab_size=5)
SMOKE_MOE = dict(SMOKE, num_experts=3, experts_per_token=2)
PD = spec.read_json(spec.ROOT / "omnibench/configs/internlm2_1_8b_pd.json")["model"]
MOE = spec.read_json(spec.ROOT / "omnibench/configs/qwen3_moe_30b_a3b.json")["model"]


def test_smoke_prefill_chunk():
    # products: 2 x (attn 48 + mlp 36) a token; attention: 4*2*2 a key, keys 3+4+5
    assert counts.prefill_chunk_flops(SMOKE, 2, 3) == 3 * 168 + 16 * 12


def test_smoke_decode_dense():
    flops, nbytes = counts.decode_step(SMOKE, [3, 5])
    assert flops == 2 * (168 + 40) + 16 * (3 + 5)
    # weights 112 + head 40 + final norm 8 + mlp 72; embeddings 16; KV 8 a token
    assert nbytes == (112 + 40 + 8 + 72) + 16 + 8 * 8 + 2 * 8 + 2 * 5 * 2


def test_smoke_decode_moe_counts_only_routed_experts():
    flops, nbytes = counts.decode_step(SMOKE_MOE, [3], routed_experts=[2])
    assert flops == (2 * (48 + 12 + 72) + 40) + 16 * 3
    assert nbytes == (112 + 40 + 8) + 3 * 4 * 4 + 2 * 36 * 2 + 8 + 3 * 8 + 8 + 10
    with pytest.raises(ValueError):
        counts.decode_step(SMOKE_MOE, [3])


def test_smoke_paged_attention():
    flops, nbytes = counts.paged_attention_call(2, 1, 2, 4, [3, 5])
    assert nbytes == 3 * 4 * 1 * 2 * 2 * 2 + 2 * 2 * 2 * 2 * 2
    assert flops == 4 * 2 * 2 * 8


def test_internlm2_prefill_chunk_at_published_width():
    per_token_layer = (2048 * 16 * 128 * 2 + 2 * 2048 * 8 * 128) + 3 * 2048 * 8192
    assert per_token_layer == 62_914_560
    assert counts.prefill_chunk_flops(PD, 0, 64) == 193_273_528_320 + 196_608 * 2080


def test_internlm2_decode_step_at_published_width():
    flops, nbytes = counts.decode_step(PD, [200] * 32)
    assert flops == 108_766_691_328 + 1_258_291_200
    assert nbytes == 4_037_505_024


def test_qwen3_moe_decode_bytes_at_published_width():
    _, all_experts = counts.decode_step(MOE, [100], routed_experts=[128] * 48)
    _, eight = counts.decode_step(MOE, [100], routed_experts=[8] * 48)
    # every expert of every layer: 48 x 128 x 3 x 2048 x 768 bf16 weights
    assert all_experts - eight == 48 * 120 * 3 * 2048 * 768 * 2
    assert all_experts > 48 * 128 * 3 * 2048 * 768 * 2


def test_bound_is_the_larger_of_the_two():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
