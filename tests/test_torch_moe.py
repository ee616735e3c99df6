# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The port's MoE layer (``conch_tpu_torch.models.moe``) against the JAX
package's, on the same numpy inputs from a seed.

``route_topk``, ``make_dispatch``, ``moe_ffn`` and ``moe_ffn_reference``
in f32 and bf16, top-1 and top-2, with capacity drops and a second choice
queued behind first choices (the cases of tests/moe_test.py:49-93), and
``load_balance_loss``. Routing is compared exactly (the experts) and at
1e-6 (the weights); the layer's output at TOLERANCES: in f32 the two sides
differ only in summation order, in bf16 each einsum's output is rounded
to bf16 (a one-ulp flip moves it by 2^-8 of itself), relative to the
output's largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conch_tpu.models import moe as jax_moe
from conch_tpu_torch.models import moe
from torch_cpu_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread a worker)

TOLERANCES = {"float32": 1e-5, "bfloat16": 3e-2}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _weights(seed: int, t: int = 16, e: int = 4, h: int = 32, f: int = 64):
    """(hidden, router, w_gate, w_up, w_down) as f32 numpy, as moe_test.py's _ffn_weights draws them."""
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(t, h)).astype(np.float32),
        rng.normal(size=(h, e)).astype(np.float32),
        (rng.normal(size=(e, h, f)) * 0.1).astype(np.float32),
        (rng.normal(size=(e, h, f)) * 0.1).astype(np.float32),
        (rng.normal(size=(e, f, h)) * 0.1).astype(np.float32),
    )


def _both(arrays, dtype: str):
    """The hidden state and experts in ``dtype`` (the router f32) on both sides."""
    jax_in = [jnp.asarray(a, jnp.float32 if i == 1 else JAX_DTYPES[dtype]) for i, a in enumerate(arrays)]
    port_in = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(TORCH_DTYPES[dtype]) if i != 1
               else torch.from_numpy(np.array(a)) for i, a in enumerate(jax_in)]
    return jax_in, port_in


def _close(out: torch.Tensor, ref, dtype: str) -> None:
    ref = torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32)))
    assert out.dtype == TORCH_DTYPES[dtype]
    err = (out.float() - ref).abs().max().item()
    tol = TOLERANCES[dtype] * max(1.0, ref.abs().max().item())
    assert err <= tol, f"max abs err {err} > {tol}"


@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_route_topk_matches_jax(top_k, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(40, 8)).astype(np.float32)
    logits[3, 5] = logits[3, 2]  # a tie: the lower index first, as lax.top_k
    w_ref, e_ref = jax_moe.route_topk(jnp.asarray(logits), top_k)
    w, e = moe.route_topk(torch.from_numpy(logits), top_k)
    assert e.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_ref))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-6, atol=1e-6)
    assert torch.equal(e[:, 0].long(), torch.from_numpy(logits).argmax(dim=-1))  # slot 0 is the argmax


@pytest.mark.parametrize("capacity", [1, 2, 3, 5, 16])
@pytest.mark.parametrize("top_k", [1, 2])
def test_make_dispatch_matches_jax(capacity, top_k):
    hidden, router, *_ = _weights(5, t=16, e=4)
    w, e = jax_moe.route_topk(jnp.asarray(hidden @ router), top_k)
    d_ref, c_ref = jax_moe.make_dispatch(w, e, 4, capacity)
    d, c = moe.make_dispatch(torch.from_numpy(np.array(w)), torch.from_numpy(np.array(e)), 4, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


def test_dispatch_capacity_drops_overflow_tokens():
    # Every token to expert 0 with capacity 2: tokens 2+ drop, earlier tokens win.
    dispatch, combine = moe.make_dispatch(torch.ones(5, 1), torch.zeros(5, 1, dtype=torch.int32), 3, 2)
    assert dispatch.sum() == 2 and dispatch[0, 0, 0] == 1 and dispatch[1, 0, 1] == 1
    assert combine[2:].sum() == 0


def test_second_choice_queues_after_first_choices():
    # Token 0 picks expert 1 first, token 1 picks it second: token 0 gets position 0.
    dispatch, _ = moe.make_dispatch(torch.full((2, 2), 0.5), torch.tensor([[1, 0], [0, 1]], dtype=torch.int32), 2, 2)
    assert dispatch[0, 1, 0] == 1 and dispatch[1, 1, 1] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k,experts", [(1, 8), (2, 4)])
@pytest.mark.parametrize("capacity", [16, 5, 2])
def test_moe_ffn_matches_jax(dtype, top_k, experts, capacity):
    """Capacity 16 keeps every token (T = 16); 5 and 2 drop some."""
    (h, r, wg, wu, wd), (ph, pr, pg, pu, pd) = _both(_weights(3, e=experts), dtype)
    ref = jax_moe.moe_ffn(h, r, wg, wu, wd, top_k=top_k, capacity=capacity)
    out = moe.moe_ffn(ph, pr, pg, pu, pd, top_k, capacity)
    _close(out, ref, dtype)
    if capacity == 16 and dtype == "float32":
        _close(out, jax_moe.moe_ffn_reference(h, r, wg, wu, wd, top_k=top_k), dtype)


def test_moe_ffn_bf16_rounds_the_combine_weights():
    """bf16 casts dispatch and combine to the compute dtype before their
    einsums, as the JAX package: the same layer with the combine weights
    left in f32 differs."""
    _, (ph, pr, pg, pu, pd) = _both(_weights(4), "bfloat16")
    routing = moe.route_topk(ph.float() @ pr, 2)
    out = moe.moe_ffn(ph, pr, pg, pu, pd, 2, 16, routing=routing)
    dispatch, combine = moe.make_dispatch(*routing, 4, 16)
    x = torch.einsum("tec,th->ech", dispatch.to(ph.dtype), ph)
    y = moe.moe_experts(x, pg, pu, pd)
    assert torch.equal(out, torch.einsum("tec,ech->th", combine.to(ph.dtype), y))
    assert not torch.equal(out, torch.einsum("tec,ech->th", combine, y.float()).to(ph.dtype))


def test_moe_ffn_takes_the_routing_given():
    (h, r, wg, wu, wd), (ph, pr, pg, pu, pd) = _both(_weights(6), "float32")
    rng = np.random.default_rng(6)
    experts = np.stack([rng.permutation(4)[:2] for _ in range(16)]).astype(np.int32)
    weights = rng.uniform(size=(16, 2)).astype(np.float32)
    ref = jax_moe.moe_ffn(h, r, wg, wu, wd, top_k=2, capacity=6, routing=(jnp.asarray(weights), jnp.asarray(experts)))
    out = moe.moe_ffn(ph, pr, pg, pu, pd, 2, 6, routing=(torch.from_numpy(weights), torch.from_numpy(experts)))
    _close(out, ref, "float32")


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_reference_matches_jax(top_k):
    (h, r, wg, wu, wd), (ph, pr, pg, pu, pd) = _both(_weights(7), "float32")
    ref = jax_moe.moe_ffn_reference(h, r, wg, wu, wd, top_k=top_k)
    _close(moe.moe_ffn_reference(ph, pr, pg, pu, pd, top_k), ref, "float32")


def test_moe_ffn_refuses_expert_parallelism():
    _, (ph, pr, pg, pu, pd) = _both(_weights(8), "float32")
    with pytest.raises(NotImplementedError, match="item 8"):
        moe.moe_ffn(ph, pr, pg, pu, pd, 2, 16, ep_axis="model")


@pytest.mark.parametrize("seed", [0, 1])
def test_load_balance_loss_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(64, 8)).astype(np.float32)
    experts = rng.integers(0, 8, (64, 2)).astype(np.int32)
    ref = jax_moe.load_balance_loss(jnp.asarray(logits), jnp.asarray(experts), 8)
    out = moe.load_balance_loss(torch.from_numpy(logits), torch.from_numpy(experts), 8)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)


def test_load_balance_loss_uniform_is_one():
    experts = torch.arange(4, dtype=torch.int32).repeat(16)[:, None]
    assert abs(moe.load_balance_loss(torch.zeros(64, 4), experts, 4).item() - 1.0) < 1e-6


@pytest.mark.parametrize("tokens", [1, 4, 8, 16, 64, 512])
@pytest.mark.parametrize("factor", [0.25, 0.5, 2.0, 4.0])
def test_capacity_matches_jax(tokens, factor):
    jax_cfg = jax_moe.MoEConfig(capacity_factor=factor)
    assert moe.MoEConfig(capacity_factor=factor).capacity(tokens) == jax_cfg.capacity(tokens)


def test_mixtral_config_matches_jax():
    ref, cfg = jax_moe.MoEConfig.mixtral_8x7b(), moe.MoEConfig.mixtral_8x7b()
    for name in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads", "num_kv_heads",
                 "head_dim", "rope_theta", "rms_norm_eps", "max_position", "sliding_window"):
        assert getattr(cfg.llama, name) == getattr(ref.llama, name), name
    assert (cfg.num_experts, cfg.top_k, cfg.capacity_factor) == (ref.num_experts, ref.top_k, ref.capacity_factor)
    assert (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.dtype) == (32, 8, 128, torch.bfloat16)
    tiny = moe.MoEConfig.tiny(hidden_size=64, num_experts=4)
    assert tiny.llama.hidden_size == 64 and tiny.num_experts == 4
