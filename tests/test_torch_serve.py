"""Port parity for the serve path: ``repro_torch.launch.serve`` and a
greedy decode loop through the port's transformer against the JAX
package's, on weights carried across by ``params_from_jax``.

The greedy loop feeds each step's argmax back, so one flipped argmax
would change every later token: at f32 the two packages' logits agree to
about 2e-6 (tests/test_torch_models.py), far inside the gap between the
reduced model's top two logits, and the tokens are held equal. The
port's ``serve`` draws its weights from ``torch.Generator``, which cannot
give JAX's draws, so its output is held against the port's own plain
model on the same weights, token for token.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch import serve as S
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]


def greedy_port(cfg, params, prompts, new_tokens):
    logits, cache, _ = T.prefill(cfg, params, prompts)
    cache = T.grow_cache(cfg, cache, new_tokens)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    out = [tok]
    for step in range(new_tokens - 1):
        logits, cache = T.decode_step(cfg, params, tok, cache,
                                      prompts.shape[1] + step)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
    return torch.cat(out, 1).numpy()


def greedy_reference(cfg, params, prompts, new_tokens, **kw):
    logits, cache, _ = JT.prefill(cfg, params, prompts, **kw)
    cache = JT.grow_cache(cfg, cache, new_tokens)
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    out = [tok]
    for step in range(new_tokens - 1):
        logits, cache = JT.decode_step(cfg, params, tok, cache,
                                       prompts.shape[1] + step, **kw)
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out.append(tok)
    return np.concatenate([np.asarray(t) for t in out], 1)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("window", [0, 16])
def test_greedy_tokens_match_reference_at_f32(window, kernels):
    over = {"sliding_window": window} if window else {}
    jcfg = jget("smollm-360m", **over).reduced()
    cfg = dataclasses.replace(get_config("smollm-360m", **over).reduced(),
                              use_kernels=kernels)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    params = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 24))
    kw = dict(flash_fn=jops.flash_attention_bshd,
              swiglu_fn=jops.swiglu) if kernels else {}
    want = greedy_reference(jcfg, jp, jnp.asarray(prompts, jnp.int32), 12,
                            **kw)
    got = greedy_port(cfg, params, torch.as_tensor(prompts), 12)
    np.testing.assert_array_equal(got, want)


def test_serve_equals_the_plain_model_on_its_weights():
    """``serve`` (kernels on; on the CPU the plain versions) gives the
    tokens of a greedy loop through the plain model on the same seeded
    weights and prompts."""
    got = S.serve("smollm-360m", batch=2, prompt_len=16, new_tokens=6,
                  seed=3, verbose=False, device="cpu")
    assert got.shape == (2, 6) and got.dtype == torch.int32
    cfg = get_config("smollm-360m").reduced()
    params = T.init_params(cfg, torch.Generator("cpu").manual_seed(3))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16))
    want = greedy_port(cfg, params, torch.as_tensor(prompts), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_is_seeded():
    kw = dict(batch=2, prompt_len=8, new_tokens=5, verbose=False,
              device="cpu")
    a = S.serve("smollm-360m", seed=0, **kw)
    assert torch.equal(a, S.serve("smollm-360m", seed=0, **kw))
    s1 = S.serve("smollm-360m", seed=0, greedy=False, **kw)
    assert torch.equal(s1, S.serve("smollm-360m", seed=0, greedy=False, **kw))
    assert int(s1.min()) >= 0 and int(s1.max()) < 512


def test_sampling_starts_from_the_prefill_argmax():
    """As in the reference, ``greedy=False`` samples only the decode
    steps: the first token is the argmax of the prefill logits. (The
    later tokens differ from the reference's by design: torch's
    generator is not JAX's.)"""
    kw = dict(batch=4, prompt_len=8, new_tokens=4, seed=2, verbose=False,
              device="cpu")
    greedy = S.serve("smollm-360m", greedy=True, **kw)
    sampled = S.serve("smollm-360m", greedy=False, **kw)
    assert torch.equal(sampled[:, 0], greedy[:, 0])
    assert not torch.equal(sampled, greedy), "the decode steps sample"


def test_serve_runs_a_windowed_dense_arch():
    """StarCoder2 (LayerNorm, GELU, no SwiGLU) through the same stack."""
    out = S.serve("starcoder2-15b", batch=1, prompt_len=8, new_tokens=3,
                  verbose=False, device="cpu")
    assert out.shape == (1, 3)


def test_serve_refuses_unported_families():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        S.serve("xlstm-125m", verbose=False, device="cpu")


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.serve(verbose=False)


def test_serve_main_on_the_cpu(capsys):
    S.main(["--device", "cpu", "--batch", "2", "--prompt", "8",
            "--tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=smollm-360m-reduced device=cpu prefill(2x8)" in out
    assert "generated:" in out


def test_python_m_entry_point():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--device", "cpu", "--tokens", "2"], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "decode 2 toks" in proc.stdout
