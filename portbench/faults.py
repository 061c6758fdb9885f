"""Faults planted in the program, for showing that a cell's check
fails: each is a context manager that patches one function of the port
for the calls made inside it (the port's sources are left alone).

- ``state_unchanged``: a training step or round that returns its state
  as it got it;
- ``half_batch``: half of a step's rows (of a round's clients) left out,
  the mean taken over the rest;
- ``answer_altered``: an answer changed where it is produced (a round's
  q cosines, a step's loss, a served token);
- ``stale_answer``: a prefill that returns the previous batch's logits.

The exchange between chips has no fault here: every cell runs on one
chip.
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = {"fl_lora": ("state_unchanged", "half_batch", "answer_altered"),
          "fedsgd": ("state_unchanged", "half_batch", "answer_altered"),
          "prefill": ("answer_altered", "stale_answer")}


@contextlib.contextmanager
def _patched(module, name: str, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def _fl_state_unchanged(make_scan):
    def make(*a, **kw):
        chunk = make_scan(*a, **kw)

        def unchanged(carry, *rest):
            _, info = chunk(carry, *rest)
            return carry, info
        return unchanged
    return make


def _half_weights(agg_q):
    def agg(deltas, w, *a, **kw):
        keep = torch.arange(w.shape[0], device=w.device) < (w.shape[0] + 1) // 2
        w = w * keep
        return agg_q(deltas, w / w.sum().clamp_min(1e-9), *a, **kw)
    return agg


def _q_altered(agg_q):
    def agg(*a, **kw):
        out, q, per = agg_q(*a, **kw)
        return out, q * 0.5, per
    return agg


def _step_wrap(change):
    def wrap(make_step):
        def make(*a, **kw):
            return change(make_step(*a, **kw))
        return make
    return wrap


def _unchanged_step(step):
    def s(params, opt_state, batch):
        _, _, metrics = step(params, opt_state, batch)
        return params, opt_state, metrics
    return s


def _half_step(step):
    def s(params, opt_state, batch):
        n = (batch["tokens"].shape[0] + 1) // 2
        return step(params, opt_state, {k: v[:n] for k, v in batch.items()})
    return s


def _loss_altered_step(step):
    def s(params, opt_state, batch):
        params, opt_state, metrics = step(params, opt_state, batch)
        return params, opt_state, dict(metrics, loss=metrics["loss"] * 1.01)
    return s


def _token_altered(prefill):
    def p(*a, **kw):
        logits, cache, memory = prefill(*a, **kw)
        return logits.roll(1, dims=-1), cache, memory
    return p


def _stale(prefill):
    last = []

    def p(*a, **kw):
        out = prefill(*a, **kw)
        last.append(out[0])
        return (last[-2] if len(last) > 1 else out[0],) + tuple(out[1:])
    return p


def plant(driver: str, fault: str):
    """The context manager planting ``fault`` for a cell of ``driver``."""
    from repro_torch.fl import round as fl_round
    from repro_torch.fl import transformer_task
    from repro_torch.models import transformer
    table = {
        ("fl_lora", "state_unchanged"): (transformer_task, "make_fl_rounds_scan",
                                         _fl_state_unchanged),
        ("fl_lora", "half_batch"): (fl_round, "aggregate_and_quality",
                                    _half_weights),
        ("fl_lora", "answer_altered"): (fl_round, "aggregate_and_quality",
                                        _q_altered),
        ("fedsgd", "state_unchanged"): (fl_round, "make_fedsgd_step",
                                        _step_wrap(_unchanged_step)),
        ("fedsgd", "half_batch"): (fl_round, "make_fedsgd_step",
                                   _step_wrap(_half_step)),
        ("fedsgd", "answer_altered"): (fl_round, "make_fedsgd_step",
                                       _step_wrap(_loss_altered_step)),
        ("prefill", "answer_altered"): (transformer, "prefill", _token_altered),
        ("prefill", "stale_answer"): (transformer, "prefill", _stale),
    }
    return _patched(*table[(driver, fault)])
