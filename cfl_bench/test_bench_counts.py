"""The benchmark's operation and byte counts against values worked out by
hand at the two configurations' sizes."""
import pytest

from cfl_bench import counts, spec

BENCH = spec.load_benchmark()
MAMBA = spec.config(BENCH, "mamba2-1.3b")["model"]
GRANITE = spec.config(BENCH, "granite-8b")["model"]


def test_kernel_8_at_the_probe_shape():
    # (768 sequences, 32 query and 8 key/value heads, 32 tokens, D 128):
    # 4 * 768 * 32 * 128 * (32 * 33 / 2) flops; Q, O at 768*32*32*128 and
    # K, V at 768*8*32*128 floats
    t = counts.attention_kernel_terms(768, 32, 8, 32, 128)
    assert t["flops"] == 4 * 768 * 32 * 128 * 528 == 6_643_777_536
    assert t["bytes"] == 4 * (2 * 100_663_296 + 2 * 25_165_824) \
        == 1_006_632_960
    assert t["bound_by"] == "bytes"
    assert t["least_s"] == pytest.approx(300.487e-6, rel=1e-5)


def test_kernel_7_at_a_2048_token_mamba2_prompt():
    # one chunk: C B^T over 256*257/2 pairs at N 128, then per head (64)
    # the causal product with P 64 and the chunk state 2*256*64*128
    chunk = 32_896 * 256 + 64 * (32_896 * 128 + 4_194_304)
    assert counts.ssd_chunk_ops(256, 64, 64, 128, 1) == chunk == 546_340_864
    t = counts.ssd_kernel_terms(2048, 256, 64, 64, 128, 1)
    assert t["flops"] == 8 * chunk == 4_370_726_912
    assert t["bytes"] == 4 * (2048 * 64 * 130 + 2 * 2048 * 128
                              + 8 * 64 * 64 * 128) == 87_031_808
    assert t["least_s"] == pytest.approx(3 * 4_370_726_912 / 495e12)


def test_kernel_7_counts_a_partial_chunk_unpadded():
    t = counts.ssd_kernel_terms(300, 256, 64, 64, 128, 1)
    part = 44 * 45 // 2 * 256 + 64 * (44 * 45 // 2 * 128 + 2 * 44 * 64 * 128)
    assert t["flops"] == 546_340_864 + part


def test_mamba2_training_round():
    # a layer's products a token: 2 * 2048 * (2*4096 + 2*128 + 64) in,
    # 2 * 4096 * 2048 out; the SSD of one 256-token sequence a layer is
    # one chunk; the head 2 * 2048 * 50288 a token; training is 3x
    layer = 2 * 2048 * 8512 + 2 * 4096 * 2048
    assert counts.ssm_layer_matmul_ops(MAMBA) == layer == 51_642_368
    forward = (48 * (2048 * layer + 8 * 546_340_864)
               + 2 * 2048 * 50288 * 2048)
    assert counts.train_ops(MAMBA, 8, 256) == 3 * forward
    assert 3 * forward / 0.74 / 67e12 == pytest.approx(0.35, abs=0.01)


def test_granite_probe_backbone():
    # per token and layer: Q, O 4096x4096, K, V 4096x1024, the SwiGLU MLP
    # 3 x 4096x14336, and causal attention over 32 positions
    layer = 2 * 4096 * 10240 + 6 * 4096 * 14336 + 4 * 32 * 128 * 528 / 32
    assert counts.dense_layer_matmul_ops(GRANITE, 32) == layer
    ops = counts.forward_ops(GRANITE, 768, 32, logits_rows=0)
    assert ops == 36 * 768 * 32 * layer
    assert ops == pytest.approx(386.2e12, rel=1e-3)


def test_mamba2_prefill_counts_the_head_once():
    one = counts.forward_ops(MAMBA, 1, 2048, logits_rows=1)
    ssd = counts.ssd_seq_ops(2048, 256, 64, 64, 128, 1)
    assert ssd == 8 * 546_340_864 + (2048 - 256) * 64 * 2 * 64 * 128
    assert one == 48 * (2048 * 51_642_368 + ssd) + 2 * 2048 * 50288
