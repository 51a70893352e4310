"""The port's checkpoints: the adapter artifact across packages, the resume
state, and resume against an uninterrupted run.

* (d) An adapter directory written by either package's
  ``save_adapter_file`` loads in the other's ``load_adapter_file`` with
  equal tensors (the same peft names, f32).
* (e) Two steps, a restart with ``resume=True``, then one step give the
  adapter and the optimizer state of three straight steps bit for bit; the
  batch order equals the JAX trainer's ``_episode_batch_stream``.
* ``CheckpointManager`` keeps the newest 3 files, publishes by rename and
  restores nothing from an empty directory; Adam8bit's ``state_dict()``
  round-trips through ``torch.load(weights_only=True)`` bit for bit.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from distrl_llm_tpu import checkpoint as jcheckpoint
from distrl_llm_tpu import trainer as jtrainer
from distrl_llm_tpu.engine.fake import FakeEngine as JFakeEngine
from distrl_llm_tpu.models import TINY, init_params
from distrl_llm_tpu.models import lora as jlora
from distrl_llm_tpu.rewards import reward_function as jreward_function
from distrl_llm_tpu.tokenizer import CharTokenizer as JCharTokenizer
from distrl_llm_tpu_torch import checkpoint, trainer
from distrl_llm_tpu_torch.engine.fake import FakeEngine
from distrl_llm_tpu_torch.learner.optim import Adam8bit, make_optimizer
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import lora_from_numpy, lora_to_numpy, params_from_numpy
from distrl_llm_tpu_torch.rewards import reward_function
from distrl_llm_tpu_torch.tokenizer import CharTokenizer
from tests.test_torch_trainer import _port_config
from tests.test_trainer import make_config, script

pytest.importorskip("safetensors.numpy")

CFG = ModelConfig(**dataclasses.asdict(TINY))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adapter_tree(seed=1, rank=4):
    tree = _np_tree(jlora.init_lora_params(jax.random.PRNGKey(seed), TINY, rank))
    rng = np.random.default_rng(seed)
    for ab in tree["layers"].values():
        ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    return tree


def _assert_trees_equal(got, want):
    assert sorted(got["layers"]) == sorted(want["layers"])
    for t, ab in want["layers"].items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(got["layers"][t][k]), ab[k], err_msg=t + k)


def test_adapter_written_by_the_port_loads_in_jax(tmp_path):
    tree = _adapter_tree()
    lora = lora_from_numpy(tree, CFG, device="cpu")
    checkpoint.save_adapter_file(lora, str(tmp_path / "ad"), rank=4, alpha=8.0, model_name="m")
    jtemplate = _np_tree(jlora.init_lora_params(jax.random.PRNGKey(0), TINY, 4))
    _assert_trees_equal(jcheckpoint.load_adapter_file(str(tmp_path / "ad"), jtemplate), tree)
    # the same directory as the JAX package writes it: files and config
    jcheckpoint.save_adapter_file(tree, str(tmp_path / "jad"), rank=4, alpha=8.0, model_name="m")
    for d in ("ad", "jad"):
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == [
            "adapter_config.json", "adapter_model.safetensors"]
    assert ((tmp_path / "ad" / "adapter_config.json").read_text()
            == (tmp_path / "jad" / "adapter_config.json").read_text())


def test_adapter_written_by_jax_loads_in_the_port(tmp_path):
    tree = _adapter_tree(2)
    jcheckpoint.save_adapter_file(tree, str(tmp_path / "jad"), rank=4, alpha=8.0)
    template = lora_from_numpy(_adapter_tree(3), CFG, device="cpu")
    got = checkpoint.load_adapter_file(str(tmp_path / "jad"), template)
    _assert_trees_equal(lora_to_numpy(got), tree)
    assert all(got["layers"][t][k].dtype == torch.float32 for t in got["layers"]
               for k in ("a", "b"))
    flat = checkpoint.load_adapter_file(str(tmp_path / "jad"), template["layers"])
    assert sorted(flat) == sorted(tree["layers"])  # a template without "layers"


def test_adapter_publication_is_atomic(tmp_path):
    lora = lora_from_numpy(_adapter_tree(), CFG, device="cpu")
    path = tmp_path / "ad"
    checkpoint.save_adapter_file(lora, str(path), rank=4, alpha=8.0)
    lora["layers"]["wq"]["a"].add_(1.0)
    checkpoint.save_adapter_file(lora, str(path), rank=4, alpha=8.0)  # steady state
    got = checkpoint.load_adapter_file(str(path), lora)
    assert torch.equal(got["layers"]["wq"]["a"], lora["layers"]["wq"]["a"])
    checkpoint.save_adapter_file(lora, str(path), rank=4, alpha=16.0)  # a changed config
    assert json.loads((path / "adapter_config.json").read_text())["lora_alpha"] == 16.0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ad"]  # no temp dirs left


def test_checkpoint_manager_keeps_the_newest_three(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.restore() is None and mgr.latest_step() is None
    for step in (1, 2, 5, 3, 4):
        mgr.save(step, {"step": step, "x": torch.full((3,), float(step))})
    assert mgr.steps() == [3, 4, 5]
    assert mgr.restore()["step"] == 5
    assert torch.equal(mgr.restore(3)["x"], torch.full((3,), 3.0))
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_3.pt", "step_4.pt", "step_5.pt"]


def test_adam8bit_state_round_trips_bit_for_bit(tmp_path):
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(300, generator=gen).requires_grad_(),
              torch.randn(3, 4, generator=gen).requires_grad_()]
    twins = [p.detach().clone().requires_grad_() for p in params]
    opt, twin = make_optimizer(params, 1e-3), make_optimizer(twins, 5.0)
    grads = [[torch.randn(p.shape, generator=gen) for p in params] for _ in range(3)]
    for p, g in zip(params, grads[0]):
        p.grad = g
    opt.step()
    torch.save(opt.state_dict(), tmp_path / "opt.pt")
    with torch.no_grad():
        for t, p in zip(twins, params):
            t.copy_(p)
    twin.load_state_dict(torch.load(tmp_path / "opt.pt", weights_only=True))
    assert twin.count == 1 and twin.param_groups[0]["lr"] == 1e-3
    for gs in grads[1:]:
        for ps in (params, twins):
            for p, g in zip(ps, gs):
                p.grad = g.clone()
        opt.step()
        twin.step()
    assert all(torch.equal(a, b) for a, b in zip(params, twins))
    with pytest.raises(ValueError, match="other parameters"):
        Adam8bit(params[:1], 1e-3).load_state_dict(opt.state_dict())


def test_lora_to_numpy_copies():
    """``lora_to_numpy`` of CPU tensors once returned views of them, so a
    snapshot taken before an optimizer step read the values after it."""
    lora = lora_from_numpy(_adapter_tree(), CFG, device="cpu")
    before = lora_to_numpy(lora)
    with torch.no_grad():
        lora["layers"]["wq"]["a"].add_(1.0)
    assert not np.array_equal(before["layers"]["wq"]["a"],
                              lora_to_numpy(lora)["layers"]["wq"]["a"])


# ------------------------------------------------------------ (e) resume

PROBLEMS = [f"q {c}" for c in "abcdefghijkl"]  # 12 problems: 3 batches of 4


def _data():
    train = {"problem": PROBLEMS, "solution": [p[-1].upper() for p in PROBLEMS]}
    return train, {k: v[:4] for k, v in train.items()}


class _Crash(FakeEngine):
    """Raises at its ``crash_at``-th generate call (1-based)."""

    def __init__(self, *a, crash_at: int, **kw):
        super().__init__(*a, **kw)
        self.crash_at = crash_at

    def generate(self, *a):
        if len(self.calls) + 1 == self.crash_at:
            raise RuntimeError("the process died here")
        return super().generate(*a)


@pytest.fixture(scope="module")
def base_model():
    return _np_tree(init_params(jax.random.PRNGKey(0), TINY))


def _trainer(base_tree, ckpt, engine, **kw):
    train, test = _data()
    cfg = _port_config(save_every=1, checkpoint_dir=ckpt and str(ckpt), lora_dropout=0.0, **kw)
    return trainer.Trainer(train, test, reward_function, cfg, tokenizer=CharTokenizer(),
                           engine=engine, model=params_from_numpy(base_tree, CFG, device="cpu"))


@pytest.mark.parametrize("learner", ["pg", "grpo"])
def test_resume_gives_the_straight_run_bit_for_bit(tmp_path, base_model, learner):
    tok = CharTokenizer()
    straight = _trainer(base_model, tmp_path / "a", FakeEngine(tok, script), learner=learner)
    straight.train()
    assert straight.total_batch_steps == 3
    # calls: the eval round, steps 1 and 2, then step 3's round dies
    crashed = _trainer(base_model, tmp_path / "b", _Crash(tok, script, crash_at=4),
                       learner=learner)
    with pytest.raises(RuntimeError, match="died"):
        crashed.train()
    assert crashed.ckpt.latest_step() == 2
    resumed = _trainer(base_model, tmp_path / "b", FakeEngine(tok, script), learner=learner,
                       resume=True)
    assert (resumed.total_batch_steps, resumed.episode, resumed.batch_in_episode,
            resumed.weight_version, resumed.total_samples_processed) == (2, 0, 2, 2, 8)
    assert resumed._rollout_weight_version == 2
    # the generator as it stood at step 2's save (the dead round drew after it)
    assert torch.equal(resumed._gen.get_state(), crashed.ckpt.restore(2)["rng"])
    resumed.train()
    assert resumed.engine.calls[0]["batch"] == 4 and len(resumed.engine.calls) == 2
    assert resumed.total_batch_steps == 3 and resumed.episode == 1
    for t, ab in straight.lora["layers"].items():
        for k, x in ab.items():
            assert torch.equal(resumed.lora["layers"][t][k], x), t + k
    got, want = resumed.optimizer.state_dict(), straight.optimizer.state_dict()
    assert got["count"] == want["count"] == 3
    for i, st in want["state"].items():
        for name, x in st.items():
            assert torch.equal(got["state"][i][name], x), (i, name)
    # a finished run resumes as a no-op
    done = _trainer(base_model, tmp_path / "b", FakeEngine(tok, script), learner=learner,
                    resume=True)
    done.train()
    assert done.total_batch_steps == 3 and len(done.engine.calls) == 1  # the eval only


@pytest.mark.parametrize("episode,skip", [(0, 0), (0, 2), (1, 0), (2, 1)])
def test_batch_order_equals_jax(base_model, episode, skip):
    train, test = _data()
    jtr = jtrainer.Trainer(train, test, jreward_function, make_config(),
                           tokenizer=JCharTokenizer(),
                           engine=JFakeEngine(JCharTokenizer(), script),
                           base_params=jax.tree_util.tree_map(jax.numpy.asarray, base_model),
                           model_cfg=TINY)
    tr = _trainer(base_model, None, FakeEngine(CharTokenizer(), script))
    got = list(tr._episode_batch_stream(episode, skip))
    want = list(jtr._episode_batch_stream(episode, skip))
    assert got == want and len(got) == 3 - skip


def test_hf_snapshots_hold_the_merged_model(tmp_path, base_model, monkeypatch):
    """``export_hf_snapshots`` writes run_<name>/model_<step> at each save
    and at the episode's end: the base with the trained adapter merged."""
    from distrl_llm_tpu_torch.models.loading import load_pretrained, state_dict_from_params
    from distrl_llm_tpu_torch.models.lora import merge_lora

    monkeypatch.chdir(tmp_path)
    tr = _trainer(base_model, None, FakeEngine(CharTokenizer(), script), run_name="r",
                  export_hf_snapshots=True, metrics_backend="null")
    tr.train()
    assert sorted(p.name for p in (tmp_path / "run_r").iterdir()) == [
        "model_1", "model_2", "model_3"]
    got, _ = load_pretrained(str(tmp_path / "run_r" / "model_3"), device="cpu")
    want = state_dict_from_params(merge_lora(tr.model, tr.lora, tr.config.lora_alpha))
    for k, v in state_dict_from_params(got).items():
        assert torch.equal(v, want[k]), k
