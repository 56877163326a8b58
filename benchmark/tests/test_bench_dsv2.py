"""The DeepSeek-V2-Lite cell (``dsv2lite258k.batch_dense``): its files run
``correct`` on the CPU at a tiny width from a copy of the benchmark that
they leave as it was, the encoder module's counts by hand, and, on the card, the
reference's bfloat16 product with a float32 result against its float32
product."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from conftest import BENCH

CELL = "dsv2lite258k.batch_dense"
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, kv_lora_rank=32, n_routed_experts=8,
            num_experts_per_tok=2, word_ids=500,
            eos_token_id=501)


def _files(root: Path):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and ".cache" not in p.parts
            and "__pycache__" not in p.parts}


def test_the_cell_runs_correct_from_a_copy_it_leaves_unchanged(tmp_path):
    """The cell's configuration, builder, reference, judge and metrics at
    a tiny width (every key of the block but the widths as committed), the
    trace off and on: ``correct``, the fp8 control past a limit, the
    instruction on the judged queries; no file of the copy changes."""
    import run
    from harness import spec

    root = tmp_path / "checkout"
    b = root / "benchmark"
    shutil.copytree(BENCH, b,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _files(b)
    cell = spec.find_cell(CELL, root=b, bench_json=root / "BENCHMARK.json")
    assert [m["name"] for m in cell.end_to_end] == ["qps",
                                                    "device_ms_per_kq",
                                                    "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "trunk_device_ms", "dense_step_mfu", "topk_stage_roofline",
        "moe_device_ms", "mla_device_ms", "expert_gemm_roofline"}
    cell.config["samples"] = 60
    cell.config["encoder"].update(TINY)
    cell.config["index"]["embed_dim"] = 64
    cell.config["engine"]["batch_buckets"] = [32]
    cell.traffic.update(batch=32, warmup_batches=1, check_questions=64)
    for trace in (False, True):
        result, compared, _, ctl = run.run_cell(
            cell, 2 ** 40 + 17, 0.3, trace, "cpu", 0.0, root=b,
            controls=["float8_e4m3fn"] if trace else ())
        assert result["correct"], compared
        assert all(v < 1e-5 for v, _ in compared.values()), compared
        if trace:
            assert any(v > cell.limits[n] for n, v in
                       ctl["float8_e4m3fn"].items()), ctl
            assert result["metrics"]["dense_step_mfu"]["value"] > 0
        else:
            assert set(result["metrics"]) == {"qps", "setup_s"}
    assert _files(b) == before


def test_seeded_params_draw_every_leaf_at_its_width_and_scale():
    """The builder's own draw, at the tiny block: every leaf at the shape
    the widths give, bfloat16 but the float32 router, a matrix's spread
    in^-0.5 (the embedding's 1), the norms at ones; the same seed draws
    the same tree, another seed another; the program gets that tree."""
    from harness import spec

    enc = json.loads((BENCH / "configs" / "hotpot258k-dsv2lite.json")
                     .read_text())["encoder"]
    enc.update(TINY)
    mod = spec.load_module("encoders", "deepseek_v2")
    tree = mod.seeded_params(enc, 2 ** 40 + 17, "cpu")
    dense, moe = tree["layers"][0], tree["layers"][1]
    shapes = {"q_proj": (96, 64), "kv_a_proj_with_mqa": (40, 64),
              "kv_b_proj": (128, 32), "o_proj": (64, 64), "kv_a_norm": (32,)}
    assert {k: tuple(v.shape) for k, v in moe["attn"].items()} == shapes
    assert tuple(tree["embed"].shape) == (512, 64)
    assert {k: tuple(v.shape) for k, v in dense["mlp"].items()} == {
        "w_gate": (96, 64), "w_up": (96, 64), "w_down": (64, 96)}
    assert {k: tuple(v.shape) for k, v in moe["experts"].items()} == {
        "w_gate": (8, 32, 64), "w_up": (8, 32, 64), "w_down": (8, 64, 32)}
    assert {k: tuple(v.shape) for k, v in moe["shared"].items()} == {
        "w_gate": (64, 64), "w_up": (64, 64), "w_down": (64, 64)}
    assert moe["router"].dtype == torch.float32 and "mlp" not in moe
    assert moe["experts"]["w_down"].dtype == torch.bfloat16
    for leaf, fan_in in ((tree["embed"], 1), (moe["experts"]["w_gate"], 64),
                         (moe["experts"]["w_down"], 32),
                         (dense["mlp"]["w_down"], 96)):
        assert float(leaf.float().std()) == pytest.approx(fan_in ** -0.5,
                                                          rel=0.1)
    assert all(bool((v == 1).all()) for v in (
        tree["norm"], moe["input_norm"], moe["post_norm"],
        moe["attn"]["kv_a_norm"]))
    again = mod.seeded_params(enc, 2 ** 40 + 17, "cpu")
    other = mod.seeded_params(enc, 2 ** 40 + 18, "cpu")
    assert torch.equal(again["layers"][2]["experts"]["w_up"],
                       tree["layers"][2]["experts"]["w_up"])
    assert not torch.equal(other["embed"], tree["embed"])
    encoder, params = mod.build(enc, 2 ** 40 + 17, "cpu")
    assert torch.equal(encoder.params["layers"][1]["router"],
                       params["layers"][1]["router"])
    assert torch.equal(params["layers"][1]["router"], moe["router"])


def test_flops_and_expert_kernel_counts_by_hand():
    """One shape worked out by hand: hidden 2048, 16 heads, nope / rope /
    v 128 / 64 / 128, rank 512, L 48, 1 dense layer of 10944 and 4 MoE
    layers of 64 experts of 1408 (top-6, 2 shared), 39.6 real tokens a
    query."""
    from harness import spec

    block = json.loads((BENCH / "configs" / "hotpot258k-dsv2lite.json")
                       .read_text())["encoder"]
    counts = spec.load_module("encoders", "deepseek_v2")
    attn = (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
            + 48 * 3072 + 48 * 2048)
    per_pos = 5 * attn + 3 * 2048 * 10944 + 4 * 3 * 2048 * 2816
    per_tok = 4 * (2048 * 64 + 6 * 3 * 2048 * 1408)
    want = 2.0 * 4096 * (48 * per_pos + 39.6 * per_tok)
    assert counts.flops(4096, block) == pytest.approx(want, rel=1e-12)
    assert 140e12 < want < 160e12
    assert counts.expert_gemm_ops(1000, 2048, 1408) == 1000 * 17301504.0
    assert counts.expert_gemm_bytes(1000, 2, 64, 2048, 1408) == (
        2 * 64 * 3 * 2048 * 1408 * 2 + 1000 * 2048 * 6)


@pytest.mark.gpu
def test_reference_out_dtype_product_is_the_float32_product(cuda_device):
    """A bfloat16-operand product with a float32 result equals the float32
    product of the same rounded operands, up to the order of the sum: at K
    2048 with unit-normal operands the sums are ~45 and the float32
    order-of-sum error ~6e-5 (a random walk of 2048 half-ulp roundings), so
    1e-3 is ~15 of those; the relative norm of the difference stays near
    float32 resolution."""
    from harness import spec

    ref = spec.load_module("reference", "hotpot_dsv2")
    g = torch.Generator(device=cuda_device).manual_seed(3)
    a = torch.randn((4096, 2048), generator=g, device=cuda_device)
    w = torch.randn((1408, 2048), generator=g, device=cuda_device)
    fast = ref.product(a, w.t(), torch.bfloat16)
    slow = ref.round_operand(a, torch.bfloat16) @ ref.round_operand(
        w, torch.bfloat16).t()
    assert not torch.backends.cuda.matmul.allow_tf32
    torch.testing.assert_close(fast, slow, rtol=0, atol=1e-3)
    assert float((fast - slow).norm() / slow.norm()) < 1e-5
    fp8 = ref.product(a, w.t(), torch.float8_e4m3fn)
    assert (fp8 - slow).abs().max() > 100 * (fast - slow).abs().max()
