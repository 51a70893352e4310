"""The port's Adam8bit (``learner/optim.py``) against the JAX package's.

The dynamic code table, the decision boundaries and the code→magnitude
table are equal; ``_quantize`` gives bit-equal int8 codes and f32 scales on
the same inputs and ``_dequantize`` bit-equal values. Three update steps
from the same numpy grads leave the parameters within ``PARAM_ATOL`` of
each other (the steps differ in the last place of f32: the two frameworks
round the bias-corrected quotient differently) and the int8 moment state
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distrl_llm_tpu.learner import optim as jo
from distrl_llm_tpu_torch.learner import optim as to

PARAM_ATOL = 1e-7
LR = 1e-3


def test_tables_equal_jax():
    np.testing.assert_array_equal(to._dynamic_table(), jo._dynamic_table())
    np.testing.assert_array_equal(to._MIDS, jo._MIDS)
    np.testing.assert_array_equal(to._LUT, jo._LUT)
    assert to.STATE_FORMAT == jo.STATE_FORMAT == 2


def _case(name, rng):
    if name == "random":  # magnitudes over 9 decades: every code decade used
        return (rng.standard_normal(4 * 256) * np.exp(rng.uniform(-20, 0, 4 * 256))
                ).astype(np.float32)
    if name == "zero":
        return np.zeros(512, np.float32)
    if name == "negative":
        return -np.abs(rng.standard_normal((3, 256))).astype(np.float32)
    if name == "tail_padded":  # 1000 = 3 full blocks + a 232-element tail
        return rng.standard_normal((10, 100)).astype(np.float32)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["random", "zero", "negative", "tail_padded"])
def test_quantize_codes_bit_equal_to_jax(name):
    x = _case(name, np.random.default_rng(0))
    jz = jo._quantize(jnp.asarray(x))
    tz = to._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tz.q.numpy(), np.asarray(jz.q))
    np.testing.assert_array_equal(tz.scale.numpy(), np.asarray(jz.scale))
    assert (tz.size, tz.shape) == (jz.size, jz.shape)
    np.testing.assert_array_equal(to._dequantize(tz).numpy(), np.asarray(jo._dequantize(jz)))


def _params(rng):
    # adapter-sized values (|x| < 0.5, where one f32 ulp is under 3e-8)
    return {"a": (0.1 * rng.standard_normal((3, 300))).astype(np.float32),
            "b": (0.1 * rng.standard_normal(77)).astype(np.float32)}


def _grads(params, rng):
    # per-element magnitudes over 6 decades, so moments use several codes
    return {k: (rng.standard_normal(v.shape) * 10.0 ** rng.uniform(-6, 0, v.shape)
                ).astype(np.float32) for k, v in params.items()}


def test_three_steps_match_jax_with_equal_int8_state():
    rng = np.random.default_rng(1)
    params = _params(rng)
    opt = jo.make_optimizer(LR)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    update = jax.jit(opt.update)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = to.make_optimizer(tp.values(), LR)
    assert isinstance(topt, to.Adam8bit)
    for _ in range(3):
        grads = _grads(params, rng)
        u, state = update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, u)
        for k, t in tp.items():
            t.grad = torch.from_numpy(grads[k])
        topt.step()
        for k, t in tp.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), atol=PARAM_ATOL, rtol=0)
            for moment in ("mu", "nu"):
                z, jz = topt.state[t][moment], getattr(state, moment)[k]
                np.testing.assert_array_equal(z.q.numpy(), np.asarray(jz.q))
                np.testing.assert_array_equal(z.scale.numpy(), np.asarray(jz.scale))
    assert topt.count == int(state.count) == 3


def test_clip_bounds_every_step_and_a_zero_grad_moves_nothing_at_step_one():
    p = torch.zeros(600)
    opt = to.Adam8bit([p], LR)
    g = torch.zeros(600)
    g[:300] = torch.logspace(-12, 2, 300)  # tiny grads beside large ones in a block
    for _ in range(4):
        before = p.clone()
        p.grad = g.clone()
        opt.step()
        assert float((p - before).abs().max()) <= 5 * LR * (1 + 1e-6)
    assert torch.isfinite(p).all()
    assert bool((p[300:] == 0).all())


def test_check_state_format_refuses_another_format():
    opt = to.Adam8bit([torch.zeros(4)], LR)
    to.check_state_format(opt)
    opt.code_version = 1
    with pytest.raises(ValueError, match="format v1"):
        to.check_state_format(opt)


def test_full_precision_adam_matches_optax_adam():
    rng = np.random.default_rng(2)
    params = _params(rng)
    opt = optax.adam(LR)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = to.make_optimizer(tp.values(), LR, use_8bit=False)
    assert isinstance(topt, torch.optim.Adam)
    for _ in range(3):
        grads = _grads(params, rng)
        u, state = opt.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, u)
        for k, t in tp.items():
            t.grad = torch.from_numpy(grads[k])
        topt.step()
    for k, t in tp.items():  # the same formula, rounded in another order
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
