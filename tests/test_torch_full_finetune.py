"""Full fine-tuning: the port against the JAX package's, on the CPU in f32.

The cases of JAX ``tests/test_full_finetune.py``, run live through both
packages on the same numpy-built params and batches:

* the train step with ``train_mode="full"`` (TINY; and a small Gemma-shaped
  config: 2 layers, head_dim 256, 2/1 heads, hidden 64, V 512, tied
  embeddings, GeGLU, +1 norms, scaled embeddings, under ``attn_impl
  "splash"``, K4's plain version on the CPU and the JAX package's
  ``attention_reference`` fallback): every parameter moves, the tied
  embedding included; two steps of pg, and of grpo with chunked logprobs;
  repeated pg steps on positive coefficients reduce the loss;
* ``TrainConfig``'s full-FT rules, and the width rule (Gemma-2B and
  Qwen2.5-0.5B fit one 80 GB card, Qwen2.5-7B raises naming item 10);
* both trainers on the ``FakeEngine`` script of ``tests/test_trainer.py``
  for two steps; a bf16 base trains in f32 masters, the rollout copy is
  the masters cast back; a round through the real dense engine samples the
  pushed weights; the resume state continues bit for bit;
* the port's own trap: with the radix cache on, a push drops the cache.

Tolerances (f32):

* the loss after each step within ``REL`` relative, at least 1 in scale
  (a PG loss sums terms of both signs: measured 6e-7 on a loss of 0.043);
* every parameter after each step within ``REL`` of the JAX value,
  relative to the leaf's largest |value| and at least 1 (the weights are
  O(0.02) to O(1)), on all but ``FLIP_SHARE`` of the leaf's elements, and
  within ``STEP_ATOL`` = 10 lr on those. The two packages sum the same
  products in another order (~1e-7 of a value); Adam's first step
  ``g / (|g| + eps)`` magnifies that where a grad cancels to near eps, and
  an int8 moment code at a decision boundary can round one step apart
  (below), which moves that element's second step anywhere inside
  Adam8bit's clip of ±5 lr. Measured over two steps: at most one element
  of a leaf past ``REL`` (3.2e-5 on w_up of the Gemma-shaped config), two
  of the 64 biases bk at lr 1e-2 (1.2e-5); over six steps at lr 5e-3 up
  to 0.1% of a leaf, the worst 0.72 lr;
* Adam8bit's state: the int8 codes equal but on ``FLIP_SHARE`` of a leaf
  (measured: 2 of 32,768 after two steps; 69 of 16,384 after six, one
  step apart or a near-zero moment's sign flipped), and the block scales
  (each block's largest |moment|, from each package's own grads and
  codes) within ``SCALE_RTOL`` relative (measured: 2.6e-4). Given the
  same grads, the two optimizers' codes are equal over a full tree and
  their scales within one ulp (``test_adam8bit_over_a_full_tree_matches_jax``):
  the port's stacked leaves quantize over the JAX leaf's blocks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distrl_llm_tpu import config as jconfig
from distrl_llm_tpu import trainer as jtrainer
from distrl_llm_tpu.engine.engine import GenerationEngine as JEngine
from distrl_llm_tpu.engine.fake import FakeEngine as JFakeEngine
from distrl_llm_tpu.learner import optim as joptim
from distrl_llm_tpu.learner import train_step as jts
from distrl_llm_tpu.models import TINY, init_params
from distrl_llm_tpu.models.configs import ModelConfig as JModelConfig
from distrl_llm_tpu.rewards import reward_function as jreward_function
from distrl_llm_tpu.tokenizer import CharTokenizer as JCharTokenizer
from distrl_llm_tpu_torch import config, trainer
from distrl_llm_tpu_torch.checkpoint import CheckpointManager
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine.engine import GenerationEngine
from distrl_llm_tpu_torch.engine.fake import FakeEngine
from distrl_llm_tpu_torch.engine.paged_engine import PagedGenerationEngine
from distrl_llm_tpu_torch.learner import optim, train_step as ts
from distrl_llm_tpu_torch.models.configs import ModelConfig, preset_for_model_name
from distrl_llm_tpu_torch.models.convert import param_stacks, params_from_numpy, params_to_numpy
from distrl_llm_tpu_torch.rewards import reward_function
from distrl_llm_tpu_torch.tokenizer import CharTokenizer
from tests.test_torch_trainer import position_reward
from tests.test_trainer import make_config, make_datasets, script

REL = 1e-5
LR = 1e-3
STEP_ATOL = 10 * LR
FLIP_SHARE = 0.01
SCALE_RTOL = 1e-3
PARAM_ATOL = 1e-7  # tests/test_torch_optim.py's: a step's last place of f32
ULP = 2.0**-22  # one f32 ulp, relative
CFG = ModelConfig(**dataclasses.asdict(TINY))
GEMMA_KW = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=2, num_kv_heads=1, head_dim=256, rope_theta=10000.0,
                attention_bias=False, tie_word_embeddings=True, hidden_act="gelu_tanh",
                rmsnorm_offset=True, scale_embeddings=True)
JGEMMA, GEMMA = JModelConfig(**GEMMA_KW), ModelConfig(**GEMMA_KW)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are too small for torch's intra-op threads to pay:
    they only spin beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _base(jcfg, seed=0):
    return _np_tree(init_params(jax.random.PRNGKey(seed), jcfg))


def _batch_np(vocab, rng, n, p_len=6, t_len=8, pad=True):
    """A batch of the JAX test's kind; with ``pad`` the prompts are
    left-padded and the answers right-padded to other lengths."""
    prompt_mask = np.ones((n, p_len), np.int32)
    answer_mask = np.ones((n, t_len), np.int32)
    if pad:
        for i in range(n):
            prompt_mask[i, :i % 3] = 0
            answer_mask[i, t_len - i % 4:] = 0
    return dict(
        prompt_ids=rng.integers(1, vocab, (n, p_len)).astype(np.int32) * prompt_mask,
        prompt_mask=prompt_mask,
        answer_ids=rng.integers(1, vocab, (n, t_len)).astype(np.int32) * answer_mask,
        answer_mask=answer_mask,
        coeffs=rng.normal(size=n).astype(np.float32),
        sample_mask=np.ones((n,), np.float32),
    )


def _close(got, want, what: str, lr: float = LR) -> None:
    """|got - want| within REL of the leaf's largest |want| (at least 1) on
    all but FLIP_SHARE of the elements, within 10 lr on those."""
    scale = max(float(np.abs(want).max()), 1.0)
    d = np.abs(np.asarray(got, np.float64) - want)
    far = d > REL * scale
    # FLIP_SHARE of a small leaf (64 biases) is under one element
    assert far.sum() <= max(FLIP_SHARE * d.size, 2), (what, float(d.max()), int(far.sum()))
    assert float(d.max()) <= STEP_ATOL / LR * lr, (what, float(d.max()))


def _jax_leaf(tree, key):
    if key.startswith("layers."):
        return tree["layers"][key.split(".", 1)[1]]
    return tree[key]


def _same_state(opt, jstate, model, *, exact: bool = False) -> None:
    """Adam8bit's int8 codes and block scales against JAX's, leaf by leaf:
    equal with ``exact``, else as the module docstring says."""
    assert opt.count == int(jstate.count)
    for key, members in param_stacks(model).items():
        st = opt.state[members[0]]
        for m, jtree in (("mu", jstate.mu), ("nu", jstate.nu)):
            jz = _jax_leaf(jtree, key)
            q, jq = st[m].q.numpy().astype(np.int32), np.asarray(jz.q).astype(np.int32)
            scale, jscale = st[m].scale.numpy(), np.asarray(jz.scale)
            if exact:
                np.testing.assert_array_equal(q, jq, err_msg=f"{key} {m}")
                np.testing.assert_allclose(scale, jscale, rtol=ULP, atol=0,
                                           err_msg=f"{key} {m} scale")
                continue
            assert (q != jq).mean() <= FLIP_SHARE, (key, m, int((q != jq).sum()))
            np.testing.assert_allclose(scale, jscale, rtol=SCALE_RTOL, atol=0,
                                       err_msg=f"{key} {m}")


def _same_params(model, jparams, what: str, lr: float = LR) -> None:
    got, want = params_to_numpy(model), _np_tree(jparams)
    assert sorted(got) == sorted(want) and sorted(got["layers"]) == sorted(want["layers"])
    for key in got:
        if key == "layers":
            for name in got["layers"]:
                _close(got["layers"][name], want["layers"][name], f"{what} layers.{name}", lr)
        else:
            _close(got[key], want[key], f"{what} {key}", lr)


def _run_steps(jcfg, cfg, tree, batches, *, learner="pg", use_8bit=True, lr=LR,
               logit_chunk=0, attn_impl="reference", micro=2):
    """Both packages' full-mode train steps over ``batches`` (numpy dicts)
    from ``tree``: (losses, jparams, jstate, model, optimizer) after the last,
    checked step by step."""
    jopt = joptim.make_optimizer(lr, use_8bit=use_8bit)
    jstep = jts.make_train_step(jcfg, learner_type=learner, optimizer=jopt, lora_scale=1.0,
                                micro_size=micro, donate=False, train_mode="full",
                                logit_chunk=logit_chunk, attn_impl=attn_impl)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    model = params_from_numpy(tree, cfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    opt = optim.make_optimizer(list(param_stacks(model).values()), lr, use_8bit=use_8bit)
    step = ts.make_train_step(cfg, learner_type=learner, optimizer=opt, lora_scale=1.0,
                              micro_size=micro, train_mode="full", logit_chunk=logit_chunk,
                              attn_impl=attn_impl)
    losses = []
    for i, b in enumerate(batches):
        jparams, jstate, jloss = step_out = jstep(
            jparams, jstate, None, jts.UpdateBatch(**{k: jnp.asarray(v) for k, v in b.items()}))
        del step_out
        loss = step(model, None, ts.UpdateBatch(**{k: torch.from_numpy(v) for k, v in
                                                   b.items()}))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=REL, atol=REL,
                                   err_msg=f"loss {i}")
        _same_params(model, jparams, f"step {i}")
        if use_8bit:
            _same_state(opt, jstate, model)
        losses.append(float(loss))
    return losses, jparams, jstate, model, opt


# ------------------------------------------------------------ the train step


@pytest.mark.parametrize("jcfg,cfg,attn", [(TINY, CFG, "reference"),
                                           (JGEMMA, GEMMA, "splash")],
                         ids=["tiny", "gemma_shaped"])
@pytest.mark.parametrize("learner,chunk", [("pg", 0), ("grpo", 4)])
def test_full_train_step_matches_jax_and_moves_every_parameter(jcfg, cfg, attn, learner, chunk):
    rng = np.random.default_rng(0)
    tree = _base(jcfg)
    batches = [_batch_np(cfg.vocab_size, rng, 4) for _ in range(2)]
    _, _, _, model, _ = _run_steps(jcfg, cfg, tree, batches, learner=learner,
                                   logit_chunk=chunk, attn_impl=attn)
    before = params_from_numpy(tree, cfg, device="cpu")
    moved = {n: bool((p.detach() != q).any()) for (n, p), (_, q) in
             zip(model.named_parameters(), before.named_parameters(), strict=True)}
    assert all(moved.values()), [n for n, m in moved.items() if not m]
    if cfg.tie_word_embeddings:
        assert model.lm_head is None and "embed" in dict(model.named_parameters())


def test_repeated_full_steps_reduce_the_pg_loss_as_jax():
    rng = np.random.default_rng(1)
    b = _batch_np(TINY.vocab_size, rng, 4, pad=False)
    b["coeffs"] = np.ones((4,), np.float32)
    losses, *_ = _run_steps(TINY, CFG, _base(TINY), [b] * 6, lr=5e-3)
    assert losses[-1] < losses[0], losses


def test_full_grpo_with_plain_adam_matches_jax():
    """The JAX test's GRPO case: optax Adam (no 8-bit state), chunked."""
    rng = np.random.default_rng(3)
    _run_steps(TINY, CFG, _base(TINY, 2), [_batch_np(TINY.vocab_size, rng, 4)],
               learner="grpo", use_8bit=False, logit_chunk=4)


def test_adam8bit_over_a_full_tree_matches_jax():
    """The same grads (numpy, a tree with stacked leaves whose per-layer
    size is not a multiple of 256: TINY's [2, 64] norms and biases) into
    both packages' Adam8bit for three steps: int8 codes equal, block
    scales within one f32 ulp (XLA's CPU code rounds the nu scale of one
    or two blocks of the larger leaves one ulp apart; the codes agree),
    parameters within ``PARAM_ATOL``; a leaf over several chunks
    (``CHUNK`` cut to 512) too."""
    tree = _base(TINY)
    rng = np.random.default_rng(4)
    jopt = joptim.make_optimizer(LR)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)

    jupdate = jax.jit(jopt.update)  # the fused update the port's rounding follows

    model = params_from_numpy(tree, CFG, device="cpu")
    opt = optim.make_optimizer(list(param_stacks(model).values()), LR)
    opt.CHUNK = 512
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * 10.0 ** rng.integers(-6, 0, x.shape)
                       ).astype(np.float32), tree)
        upd, jstate = jupdate(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for key, members in param_stacks(model).items():
            g = _jax_leaf(grads, key)
            for i, p in enumerate(members):
                p.grad = torch.from_numpy(np.ascontiguousarray(g[i] if len(members) > 1
                                                               or key.startswith("layers.")
                                                               else g))
        opt.step()
        got, want = params_to_numpy(model), _np_tree(jparams)
        for name in got["layers"]:
            np.testing.assert_allclose(got["layers"][name], want["layers"][name],
                                       atol=PARAM_ATOL, rtol=0, err_msg=name)
        for key in ("embed", "final_norm", "lm_head"):
            np.testing.assert_allclose(got[key], want[key], atol=PARAM_ATOL, rtol=0, err_msg=key)
        _same_state(opt, jstate, model, exact=True)


def test_full_step_refuses_a_kl_term():
    opt = optim.make_optimizer([torch.zeros(1, requires_grad=True)], 1e-3)
    with pytest.raises(ValueError, match="kl_coeff"):
        ts.make_train_step(CFG, optimizer=opt, lora_scale=1.0, micro_size=2,
                           train_mode="full", kl_coeff=0.1)
    with pytest.raises(ValueError, match="kl_coeff"):
        jts.make_train_step(TINY, optimizer=joptim.make_optimizer(1e-3), lora_scale=1.0,
                            micro_size=2, train_mode="full", kl_coeff=0.1)


def test_params_to_numpy_round_trips_a_tied_tree_and_copies():
    tree = _base(JGEMMA)
    model = params_from_numpy(tree, GEMMA, device="cpu")
    back = params_to_numpy(model)
    assert sorted(back) == sorted(tree) == ["embed", "final_norm", "layers"]
    for name, arr in tree["layers"].items():
        np.testing.assert_array_equal(back["layers"][name], arr)
    np.testing.assert_array_equal(back["embed"], tree["embed"])
    with torch.no_grad():
        model.embed.add_(1.0)
    np.testing.assert_array_equal(back["embed"], tree["embed"])  # a copy, not a view


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("kw", [dict(base_quant="int8"), dict(write_adapter_file=True),
                                dict(lora_dropout=0.1), dict(kl_coeff=0.1),
                                dict(engine_impl="paged", continuous_batching=True,
                                     max_concurrent_sequences=8, spec_drafter="self")])
def test_full_finetune_rules_match_jax(kw):
    kw = dict(full_finetune=True, model="tiny", **kw)
    with pytest.raises(ValueError, match="full_finetune"):
        jconfig.TrainConfig(**kw)
    with pytest.raises(ValueError, match="full_finetune"):
        config.TrainConfig(**kw)
    kw.pop("full_finetune")
    jconfig.TrainConfig(**kw)  # the rule is full fine-tuning's
    config.TrainConfig(**kw)


@pytest.mark.parametrize("model,fits", [("google/gemma-2b", True),
                                        ("Qwen/Qwen2.5-0.5B-Instruct", True),
                                        ("tiny", True),
                                        ("Qwen/Qwen2.5-7B-Instruct", False),
                                        ("meta-llama/Meta-Llama-3-8B", False)])
def test_full_finetune_validates_where_one_card_holds_it(model, fits):
    jconfig.TrainConfig(full_finetune=True, model=model)  # the JAX package takes every width
    # so does the port's config: the Trainer holds the width to the card it
    # runs on and the learner mesh's fsdp; here one 80 GB card at fsdp 1
    assert config.TrainConfig(full_finetune=True, model=model).full_finetune
    preset = preset_for_model_name(model)
    if fits:
        config.check_full_finetune_fits(preset, hbm_bytes=80 * 10**9)
    else:
        with pytest.raises(ValueError, match="mesh.fsdp"):
            config.check_full_finetune_fits(preset, hbm_bytes=80 * 10**9)


def test_full_finetune_bytes_at_gemma_2b():
    from distrl_llm_tpu_torch.models.configs import GEMMA_2B

    assert GEMMA_2B.param_count == 2_506_172_416
    need = config.full_finetune_bytes(GEMMA_2B)
    assert need["masters"] == need["grads"] == 4 * GEMMA_2B.param_count
    assert 30e9 < need["total"] < 31e9
    config.check_full_finetune_fits(GEMMA_2B, hbm_bytes=80 * 10**9)
    with pytest.raises(ValueError, match="mesh.fsdp"):
        config.check_full_finetune_fits(GEMMA_2B, hbm_bytes=32 * 10**9)


# ----------------------------------------------------------------- trainer


def _port_config(**kw):
    jcfg = make_config(**kw)
    return config.TrainConfig(**{f: getattr(jcfg, f)
                                 for f in config.TrainConfig.__dataclass_fields__})


class _Recorder:
    def __init__(self):
        self.records = []

    def log(self, m, step):
        self.records.append((step, dict(m)))

    def finish(self):
        pass


def _trainers(tree, *, jengine, engine, reward_fns=(jreward_function, reward_function),
              dtype=torch.float32, **kw):
    train, test = make_datasets()
    jtr = jtrainer.Trainer(train, test, reward_fns[0], make_config(full_finetune=True, **kw),
                           tokenizer=JCharTokenizer(), engine=jengine, model_cfg=TINY,
                           base_params=jax.tree_util.tree_map(jnp.asarray, tree))
    model = params_from_numpy(tree, CFG, dtype=dtype, device="cpu")
    tr = trainer.Trainer(train, test, reward_fns[1], _port_config(full_finetune=True, **kw),
                         tokenizer=CharTokenizer(), engine=engine, model=model)
    jtr.sink, tr.sink = _Recorder(), _Recorder()
    return jtr, tr


def test_trainer_on_the_fake_engine_matches_jax():
    """Two steps of each trainer in full mode: the losses, the trained tree
    and the optimizer state after each step as above; the metric records'
    names equal."""
    tree = _base(TINY)
    jtr, tr = _trainers(tree, jengine=JFakeEngine(JCharTokenizer(), script, max_new_tokens=24),
                        engine=FakeEngine(CharTokenizer(), script, max_new_tokens=24))
    snaps, jsnaps = [], []
    for t, out in ((tr, snaps), (jtr, jsnaps)):
        update = t._update_on_candidates

        def wrapped(*a, _t=t, _u=update, _out=out, **k):
            _u(*a, **k)
            _out.append(params_to_numpy(_t.lora) if _t is tr else _np_tree(_t.lora))
        t._update_on_candidates = wrapped
    jtr.train()
    tr.train()
    assert len(snaps) == len(jsnaps) == 2
    for i, (got, want) in enumerate(zip(snaps, jsnaps)):
        for name in got["layers"]:
            _close(got["layers"][name], want["layers"][name], f"step {i} layers.{name}")
        for key in ("embed", "final_norm", "lm_head"):
            _close(got[key], want[key], f"step {i} {key}")
    _same_state(tr.optimizer, jtr.opt_state, tr.lora)
    recs = [m for _, m in tr.sink.records if "loss" in m]
    jrecs = [m for _, m in jtr.sink.records if "loss" in m]
    assert len(recs) == len(jrecs) == 2
    for m, jm in zip(recs, jrecs):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=REL, atol=REL)
    assert tr._engine_params() == (tr._rollout_model, None) and tr.model is None


def test_bf16_base_trains_in_f32_master_weights():
    tree = _base(TINY)
    tr = _trainers(tree, jengine=JFakeEngine(JCharTokenizer(), script, max_new_tokens=24),
                   engine=FakeEngine(CharTokenizer(), script, max_new_tokens=24),
                   dtype=torch.bfloat16)[1]
    assert all(p.dtype == torch.float32 and p.requires_grad for p in tr.lora.parameters())
    rollout, lora = tr._engine_params()
    assert lora is None and all(p.dtype == torch.bfloat16 for p in rollout.parameters())
    version = rollout.weights_version
    with torch.no_grad():
        for p in tr.lora.parameters():
            p.add_(0.25)
    tr._push_weights()
    assert rollout.weights_version == version + 1 and tr._engine_params()[0] is rollout
    for p, m in zip(rollout.parameters(), tr.lora.parameters(), strict=True):
        assert torch.equal(p, m.detach().to(torch.bfloat16))


def test_the_hf_snapshot_holds_the_trained_tree(tmp_path, monkeypatch):
    """``export_hf_snapshot`` in full mode writes the trained tree (the
    f32 masters), which ``load_pretrained`` reads back equal."""
    from distrl_llm_tpu_torch.models.loading import load_pretrained

    monkeypatch.chdir(tmp_path)
    tr = _trainers(_base(TINY), jengine=JFakeEngine(JCharTokenizer(), script, max_new_tokens=24),
                   engine=FakeEngine(CharTokenizer(), script, max_new_tokens=24),
                   run_name="full", export_hf_snapshots=True)[1]
    with torch.no_grad():
        for p in tr.lora.parameters():
            p.add_(0.125)
    tr.export_hf_snapshot()
    loaded, cfg = load_pretrained(str(tmp_path / "run_full" / "model_0"), dtype=torch.float32,
                                  device="cpu")
    assert cfg == CFG
    for p, q in zip(loaded.parameters(), tr.lora.parameters(), strict=True):
        assert torch.equal(p, q.detach())


def test_a_round_updates_the_weights_and_the_engine_samples_them():
    """The JAX test's trainer round on the real dense engines (f32, lr
    1e-2), greedy so both packages train on one batch (the rewards by
    position in the group, ``tests/test_torch_trainer.py``'s, topk 2):
    the trained tree as above, the rollout copy equal to the masters, the
    rollout logits moved by the push, and no adapter to export."""
    tree = _base(TINY)
    lr = 1e-2
    kw = dict(max_prompt_tokens=16, max_new_tokens=12, eos_token_ids=[3], pad_token_id=0,
              capture_logprobs=False)
    jeng = JEngine(TINY, cache_dtype=jnp.float32, autotune=False, scan_chunk=0, **kw)
    eng = GenerationEngine(CFG, cache_dtype=torch.float32, device="cpu", **kw)
    jtr, tr = _trainers(tree, jengine=jeng, engine=eng,
                        reward_fns=(position_reward, position_reward), lr=lr, topk=2,
                        max_new_tokens=12, temperature=0.0, eval_temperature=0.0)
    train, _ = make_datasets()
    batch = {"problem": train["problem"][:4], "solution": train["solution"][:4]}
    ids = torch.tensor([[5, 6, 7, 8]])
    before = tr._rollout_model(ids)[0].detach().clone()
    jtr._train_batch(batch, episode=0)
    tr._train_batch(batch, episode=0)
    _same_params(tr.lora, jtr.lora, "round", lr)
    rollout, lora = tr._engine_params()
    assert lora is None and rollout is not tr.lora
    for p, m in zip(rollout.parameters(), tr.lora.parameters(), strict=True):
        assert torch.equal(p, m.detach())
    assert not torch.equal(rollout(ids)[0].detach(), before)
    with pytest.raises(RuntimeError, match="adapter"):
        tr.save_adapter()
    recs = [m for _, m in tr.sink.records if "loss" in m]
    jrecs = [m for _, m in jtr.sink.records if "loss" in m]
    np.testing.assert_allclose(recs[-1]["loss"], jrecs[-1]["loss"], rtol=REL, atol=REL)


def test_full_resume_continues_bit_for_bit(tmp_path):
    """Step 1, a checkpoint, a new trainer resumed from it, step 2: the
    tree and the optimizer state equal an uninterrupted run's."""
    tree = _base(TINY)

    def make(ckpt=None, resume=False):
        kw = dict(checkpoint_dir=str(ckpt), resume=resume) if ckpt else {}
        return _trainers(tree, jengine=JFakeEngine(JCharTokenizer(), script, max_new_tokens=24),
                         engine=FakeEngine(CharTokenizer(), script, max_new_tokens=24), **kw)[1]

    train, _ = make_datasets()
    batches = [{"problem": train["problem"][i:i + 4], "solution": train["solution"][i:i + 4]}
               for i in (0, 4)]
    whole = make()
    for i, b in enumerate(batches):
        whole._train_batch(b, 0)
    first = make(tmp_path)
    first._train_batch(batches[0], 0)
    first.save_checkpoint()
    assert CheckpointManager(str(tmp_path)).latest_step() == 1
    resumed = make(tmp_path, resume=True)
    assert resumed.total_batch_steps == 1
    for p, q in zip(resumed._rollout_model.parameters(), first.lora.parameters(), strict=True):
        assert torch.equal(p, q.detach())  # the resumed masters were pushed
    resumed._train_batch(batches[1], 0)
    for p, q in zip(resumed.lora.parameters(), whole.lora.parameters(), strict=True):
        assert torch.equal(p, q)
    a, b = resumed.optimizer.state_dict(), whole.optimizer.state_dict()
    assert a["count"] == b["count"]
    for i in a["state"]:
        assert all(torch.equal(a["state"][i][k], b["state"][i][k]) for k in a["state"][i])


# ------------------------------------------------------------ engines, CLI


def test_every_engine_path_samples_the_rollout_copy_with_no_adapter():
    """Full mode hands the engines (rollout copy, None): the dense engine
    and the paged engine's wave and refill schedulers give one greedy
    round's tokens (f32)."""
    model = params_from_numpy(_base(TINY), CFG, device="cpu")
    kw = dict(max_prompt_tokens=16, max_new_tokens=6, eos_token_ids=[3], pad_token_id=0,
              cache_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    ids = np.zeros((3, 16), np.int32)
    mask = np.zeros((3, 16), np.int32)
    for i, n in enumerate((16, 9, 4)):
        ids[i, 16 - n:] = rng.integers(4, TINY.vocab_size, n)
        mask[i, 16 - n:] = 1
    sampling = SamplingConfig(max_tokens=6, temperature=0.0, n=2)
    engines = [GenerationEngine(CFG, **kw), PagedGenerationEngine(CFG, page_size=4, **kw),
               PagedGenerationEngine(CFG, page_size=4, scheduler="refill",
                                     max_concurrent_rows=4, **kw)]
    tokens = [e.generate(model, None, ids, mask, sampling, 0).tokens for e in engines]
    for t in tokens[1:]:
        np.testing.assert_array_equal(t, tokens[0])


def test_make_engine_charges_the_learner_state_in_full_mode():
    """The paged engine's KV budget (``kv_pool_pages`` under
    ``learner_gpu_usage``) subtracts full fine-tuning's f32 masters, grads
    and moments beside the rollout weights."""
    model = params_from_numpy(_base(TINY), CFG, device="cpu")
    kw = dict(engine_impl="paged", learner_gpu_usage=0.9)
    lora = trainer.make_engine(_port_config(**kw), model, CharTokenizer(), hbm_bytes=2**26)
    full = trainer.make_engine(_port_config(full_finetune=True, **kw), model, CharTokenizer(),
                               hbm_bytes=2**26)
    need = config.full_finetune_bytes(CFG, "float32")
    from distrl_llm_tpu_torch.engine.budget import page_bytes

    learner = need["masters"] + need["grads"] + need["moments"]
    pb = page_bytes(CFG, 128)
    assert lora.max_kv_pages - full.max_kv_pages in (learner // pb, learner // pb + 1)


def test_the_cli_smoke_trains_in_full_mode(capsys):
    from distrl_llm_tpu_torch import train_distributed as cli

    cli.main(["--smoke", "--device", "cpu", "--full_finetune"])
    assert "SMOKE OK — 2 train steps on cpu" in capsys.readouterr().out


# ------------------------------------------------------------- prefix cache


def test_a_full_finetune_push_drops_the_prefix_cache():
    """The radix cache keys its KV on the weights that wrote it. In full
    mode the adapter is None every round and the push rewrites the
    rollout copy in place, so the key is the model's ``weights_version``:
    a round after a push must miss where a round without one hits."""
    tree = _base(TINY)
    model = params_from_numpy(tree, CFG, device="cpu")
    eng = PagedGenerationEngine(CFG, max_prompt_tokens=16, max_new_tokens=6,
                                eos_token_ids=[3], pad_token_id=0, cache_dtype=torch.float32,
                                page_size=4, scheduler="refill", max_concurrent_rows=4,
                                continuous_admission=True, prefix_cache=True, device="cpu")
    rng = np.random.default_rng(0)
    ids = np.zeros((2, 16), np.int32)
    mask = np.zeros((2, 16), np.int32)
    ids[:, 4:] = rng.integers(4, TINY.vocab_size, (2, 12))
    mask[:, 4:] = 1
    sampling = SamplingConfig(max_tokens=6, temperature=0.0, n=2)
    eng.generate(model, None, ids, mask, sampling, 0)
    eng.generate(model, None, ids, mask, sampling, 0)
    assert eng.last_pool_stats["prefill_tok_saved"] > 0  # the same weights: warm
    with torch.no_grad():
        model.embed.mul_(1.5)
    model.weights_version += 1  # what the trainer's push does after its copy
    eng.generate(model, None, ids, mask, sampling, 0)
    assert eng.last_pool_stats["prefill_tok_saved"] == 0
    # and through the trainer: its push bumps the version
    tr = _trainers(tree, jengine=JFakeEngine(JCharTokenizer(), script, max_new_tokens=24),
                   engine=eng)[1]
    rollout = tr._engine_params()[0]
    eng.generate(rollout, None, ids, mask, sampling, 0)
    eng.generate(rollout, None, ids, mask, sampling, 0)
    assert eng.last_pool_stats["prefill_tok_saved"] > 0
    tr._push_weights()
    eng.generate(rollout, None, ids, mask, sampling, 0)
    assert eng.last_pool_stats["prefill_tok_saved"] == 0


# ---------------------------------------------------------- chip_smoke.py

FULL_REHEARSAL = """
import dataclasses, sys, tempfile
from pathlib import Path
for name in ("safetensors", "tokenizers", "transformers", "datasets", "jax"):
    sys.modules[name] = None  # importing any of them now raises
sys.path.insert(0, ".")
import torch
torch.set_num_threads(1)  # tiny tensors: threads only contend with the other workers
import chip_smoke as cs
from distrl_llm_tpu_torch.models.configs import GEMMA_2B

cfg = dataclasses.replace(GEMMA_2B, num_layers=2, vocab_size=512, hidden_size=64,
                          intermediate_size=128, num_heads=2, num_kv_heads=1)
kw = dict(max_new_tokens=8, eval_n=2)
with tempfile.TemporaryDirectory() as tmp:
    tok_dir, _ = cs.write_unigram_tokenizer(Path(tmp) / "tok", cfg.vocab_size)
    a = cs.full_finetune_run(cfg, "cpu", seed=0, workdir=Path(tmp) / "a", tokenizer_dir=tok_dir,
                             hbm_bytes=2**30, config_kw=kw)
    cs.check_trainer_run(a, 2, steps=2, lr=a["config"].lr, cuda=False)
    held = cs.check_full_run(a, steps=2)
    assert held["max_move"] > 0 and all(d > 0 for d in held["probe_delta"][1:]), held
    assert held["probe_delta"][0] == 0, held
    cm = cs.cache_miss_after_a_full_push(cfg, "cpu", a["trainer"], page_size=8)
    assert cm["saved"][0] == 0 < cm["saved"][1] and cm["saved"][2] == 0 and cm["same"], cm
    assert cm["versions"][2] == cm["versions"][1] + 1, cm
    model = a["trainer"]._engine_params()[0]
    b = cs.lora_gemma_run(cfg, "cpu", model, seed=0, workdir=Path(tmp) / "b",
                          tokenizer_dir=tok_dir, hbm_bytes=2**30, config_kw=kw)
    cs.check_trainer_run(b, 2, steps=1, lr=b["trainer"].config.lr, cuda=False)
    assert b["counts"] == {k["name"]: 0 for k in cs.KERNELS}  # CPU: no launch
print("REHEARSAL OK")
"""


def test_chip_smoke_full_finetune_phase_rehearses_on_cpu():
    """Phase 10 of chip_smoke.py on the CPU at a 2-layer, 64-wide,
    512-token cut of Gemma-2B (head_dim 256 kept), 8 new tokens, in a
    process where ``safetensors``, ``tokenizers``, ``transformers``,
    ``datasets`` and ``jax`` cannot be imported: (a) full fine-tuning's two
    steps with every parameter moved, the rollout copy equal to the masters
    and the probe logits moved by the push only, the radix cache dropped
    by a push; (b) one LoRA step over the trained weights."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", FULL_REHEARSAL], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REHEARSAL OK" in proc.stdout
