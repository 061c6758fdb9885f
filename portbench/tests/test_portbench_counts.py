"""The operation and byte counts against hand counts at small shapes."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.model import Model
from portbench.yardstick import flops, weights
from portbench.yardstick.peaks import bound_s

DENSE = {"family": "dense", "num_layers": 2, "d_model": 16, "num_heads": 4,
         "num_kv_heads": 2, "head_dim": 4, "d_ff": 24, "vocab_size": 10,
         "tie_embeddings": True, "dtype": "float32"}


def test_attention_pairs_by_hand():
    assert flops.attention_pairs(4) == 1 + 2 + 3 + 4
    assert flops.attention_pairs(1) == 1


def test_layer_weights_by_hand():
    # q, k, v, o: 16 x 4 x (4 + 2 + 2 + 4); MLP 3 x 16 x 24
    assert flops.layer_weights(DENSE) == 16 * 4 * 12 + 3 * 16 * 24


def test_forward_flops_by_hand():
    B, S = 2, 5
    lw = flops.layer_weights(DENSE)
    want = (2 * lw * B * S * 2 + 4 * 4 * 4 * 15 * B * 2 + 2 * 16 * 10 * B * 1)
    assert flops.forward_flops(DENSE, B, S, 1) == want
    assert flops.train_flops(DENSE, B, S) == 3 * flops.forward_flops(DENSE, B, S, S)


def test_forward_flops_match_flop_counter():
    """The reference's products as FlopCounterMode counts them: the
    count, less the causal pairs' attention, plus all S x S pairs the
    reference's masked attention multiplies out."""
    B, S = 3, 2
    p = weights.model_params(DENSE, 0, torch.device("cpu"))
    toks = torch.zeros(B, S, dtype=torch.int64)
    ref = Model(DENSE, p)
    with FlopCounterMode(display=False) as fc:
        ref.logits(ref.hidden(toks))
    per_pair = 4 * 4 * 4 * B * 2            # 4 hd H, B sequences, 2 layers
    want = flops.forward_flops(DENSE, B, S, S) \
        + per_pair * (S * S - flops.attention_pairs(S))
    assert fc.get_total_flops() == want


def test_lora_step_flops_by_hand():
    B, S, r = 2, 3, 4
    f = flops.lora_step_flops(DENSE, B, S, r, ["attn/wq", "mlp/w_up"])
    ad = 6 * r * ((16 + 16) + (16 + 24)) * B * S * 2
    assert f == 2 * flops.forward_flops(DENSE, B, S, S) + ad


def test_kernel_costs_by_hand():
    assert flops.swiglu_cost(2, 3, 4) == (4 * 2 * 3 * 4, 2 * (6 + 24 + 8))
    fl, by = flops.flash_attention_cost(1, 2, 1, 3, 4)
    assert fl == 4 * 4 * 2 * 6 and by == 2 * 3 * 4 * (4 + 2)
    assert flops.fedavg_agg_quality_cost(3, 10) == (120, 4 * 4 * 10 + 24)


def test_bound_picks_the_larger_term():
    t, which = bound_s(989e12, 0)
    assert which == "operations" and abs(t - 1.0) < 1e-12
    t, which = bound_s(0, 3.35e12)
    assert which == "bytes" and abs(t - 1.0) < 1e-12


def test_train_count_is_six_n_plus_attention_and_head():
    """The frozen copy of the port's 6 N count is train_flops less the
    attention's pairs and the LM head."""
    B, S = 2, 7
    attn = 3 * 4 * 4 * 4 * flops.attention_pairs(S) * B * 2
    head = 6 * 16 * 10 * B * S
    assert flops.train_flops(DENSE, B, S) == \
        flops.model_flops_per_token(DENSE) * B * S + attn + head
