"""The plain f32 reference against the port at reduced sizes on the CPU:
the same weights and inputs give the same logits, losses and training
steps; the reference's threefry draws are the port's."""
import numpy as np
import pytest
import torch

from conftest import tiny_spec
from portbench import harness
from portbench.drivers import port_config
from portbench.reference import fl_round
from portbench.reference.model import Model
from portbench.yardstick import inputs, weights
from portbench.yardstick.spans import Spans

CPU = torch.device("cpu")


@pytest.mark.parametrize("workload", ["prefill.smollm-360m"])
def test_last_logits_and_loss_match_the_port(workload):
    from repro_torch.models import transformer as T
    cfg = tiny_spec(workload).config
    p = weights.model_params(cfg, 5, CPU)
    toks = inputs.prompts(1, 3, 70, cfg["vocab_size"], 1, CPU)[0]
    pc = port_config(cfg)
    logits, _, _ = T.prefill(pc, p, toks)
    ref = Model(cfg, p)
    want = ref.last_logits(toks)
    assert torch.allclose(logits[:, -1], want, atol=1e-4, rtol=1e-4)
    tg = toks.roll(-1, 1)
    loss, _ = T.loss_fn(pc, p, {"tokens": toks, "targets": tg})
    assert abs(float(loss) - float(ref.loss(toks, tg))) < 1e-5


def test_threefry_draws_are_the_ports():
    from repro_torch import random as trandom
    from repro_torch.fl import device_data
    seed, rnd, slots, E, b = 3_000_000_017, 7, 5, 2, 4
    _, pos_u = device_data.sample_positions(
        trandom.prng_key(seed), torch.tensor([rnd]), slots, E, b)
    for k in range(slots):
        key = fl_round.fold_in(fl_round.fold_in(fl_round.key(seed), rnd), k)
        u = fl_round.uniform(fl_round.split2(key)[1], E * b).reshape(E, b)
        assert np.array_equal(u, pos_u[0, k].numpy())


@pytest.mark.parametrize("workload", ["fl_lora.smollm-360m",
                                      "fedsgd.smollm-360m"])
def test_training_readings_vanish_in_f32(workload):
    """In f32 the program and the reference follow the same steps: every
    number compared is at round-off."""
    spec = tiny_spec(workload)
    drv = harness.driver_class(spec)(spec, 2**31 + 11, CPU, Spans(), 0.2)
    drv.setup()
    drv.window(0.2)
    drv.release()
    for name, value in drv.check():
        assert value < 1e-4, (name, value)


def test_prefill_gap_vanishes_in_f32():
    spec = tiny_spec("prefill.smollm-360m")
    drv = harness.driver_class(spec)(spec, 9, CPU, Spans(), 0.3)
    drv.setup()
    drv.window(0.3)
    drv.release()
    assert dict(drv.check())["served_logit_gap"] < 1e-5
