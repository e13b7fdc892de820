"""The benchmark's operation and byte counts against independent counts."""

import json
import math
import pathlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import counts, weights
from benchmark.reference import matcher, model

ROOT = pathlib.Path(__file__).resolve().parents[2]
TINY = dict(enc_depth=4, enc_dim=64, enc_heads=4, dec_depth=4, dec_dim=48, dec_heads=4,
            feature_dim=32, last_dim=16, layer_dims=[16, 24, 32, 48])


def config(name: str, **over) -> dict:
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("name", ["mast3r512", "monst3r512"])
@pytest.mark.parametrize("h, w", [(64, 80), (48, 48)])
def test_model_flops_equal_the_reference_forward_counted_by_torch(name, h, w):
    """The layer-by-layer count of a pair's forward equals what torch's
    FLOP counter reads from the plain reference on TINY (its resizes are
    interpolations, which neither counts)."""
    cfg = config(name, **TINY)
    params = weights.make_params(cfg, 3, "cpu", served=False)
    img = torch.randn(2, h, w, 3, generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model.pair(params, cfg, img, img)
    assert fc.get_total_flops() == 2 * counts.pair_forward_flops(cfg, h, w)


def test_encoder_flops_by_hand_on_tiny():
    cfg = config("mast3r512", **TINY)
    n, e = 20, 64  # 64x80 in 16-pixel patches
    embed = 2 * n * 768 * e
    block = 2 * n * e * 3 * e + 2 * n * n * e * 2 + 2 * n * e * e + 2 * 2 * n * e * 4 * e
    assert counts.encoder_flops(cfg, 64, 80) == embed + 4 * block


def test_train_step_flops_are_three_forwards():
    cfg = config("monst3r512")
    assert counts.train_step_flops(cfg, 8, 384, 512) == 24 * counts.pair_forward_flops(cfg, 384, 512)


def test_attention_bound_by_hand():
    # (8, 16, 768, 64) bf16: QK^T and PV are 4 b h n^2 d operations, the
    # bytes q, k, v and o at 2 bytes each
    flops = 4 * 8 * 16 * 768 * 768 * 64
    assert counts.attention_bound_s((8, 16, 768, 64)) == pytest.approx(flops / 989e12)
    n_bytes = 4 * 1 * 1 * 8 * 64 * 2  # eight tokens: bound by bytes
    assert counts.attention_bound_s((1, 1, 8, 64)) == pytest.approx(n_bytes / 3.35e12)
    calls = counts.attention_calls(config("monst3r512"), 8, 384, 512)
    assert calls.count((8, 16, 768, 64)) == 48 and calls.count((8, 12, 768, 64)) == 48


def test_tile_match_bound_and_window_positions_by_hand():
    T, tsz, crop, fd, h, w = 768, 256, 48, 24, 384, 512
    ops = 5.0 * T * tsz * crop * crop / 67e12 + 2.0 * fd * 1000 / 989e12
    assert counts.tile_match_bound_s(T, tsz, crop, fd, h, w, 1000) == pytest.approx(ops)
    # one tile, one query whose ray is the crop's pixel (5, 7): the window
    # of +-15 is clipped at the crop's left and top edges
    rays = torch.nn.functional.normalize(torch.randn(64, 64, 3), dim=-1)
    q = rays[7, 5].reshape(1, 1, 3)
    pos = matcher.window_positions(rays, q, torch.tensor([[0, 0]]), 48, 15)
    assert pos == (5 + 15 + 1) * (7 + 15 + 1)


def test_weights_are_drawn_at_their_scales_in_their_types():
    cfg = config("mast3r512", **TINY)
    served = weights.make_params(cfg, 5, "cpu", served=True)
    assert served["enc_blocks"][0]["attn"]["qkv"]["w"].dtype == torch.bfloat16
    assert served["enc_blocks"][0]["norm1"]["w"].dtype == torch.bfloat16
    assert served["enc_norm"]["w"].dtype == torch.float32
    assert served["head1"]["dpt"]["head"]["conv3"]["b"].dtype == torch.float32
    f32 = weights.make_params(cfg, 5, "cpu", served=False)
    w = f32["enc_blocks"][1]["mlp"]["fc1"]["w"]
    assert float(w.std()) == pytest.approx(math.sqrt(2.0 / (64 + 256)), rel=0.05)
    assert float(f32["head2"]["dpt"]["head"]["conv3"]["w"].std()) == pytest.approx(
        cfg["head_out_std"], rel=0.3)
    again = weights.make_params(cfg, 5, "cpu", served=False)
    assert torch.equal(again["dec_blocks2"][3]["cross"]["k"]["w"],
                       f32["dec_blocks2"][3]["cross"]["k"]["w"])
