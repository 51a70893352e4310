"""The two kernel domains the port took last, held to the JAX package on the
CPU: K3 (``ops/quant_matmul.py``) at adapter ranks above 64, which the
kernel walks in chunks of 64 (``plan_rank``), and K5
(``ops/paged_native.py``) past 64 query rows a (row, kv head), which the
kernel spreads over row tiles (``plan_row_tiles``).

* K3's plain version against the JAX package's Pallas kernel in interpret
  mode at ranks 96-256, int4 g32 and int8, f32 and bf16 x: f32 within
  ``QMM_RTOL`` of max |y| (``tests/test_torch_quant.py``'s tolerance at
  rank 8); bf16 within two bf16 ulps of the value plus that (each side
  rounds y up to four times, and a sum taken in another order may land an
  ulp apart at any of them).
* K5's plain version against the JAX verify kernel in interpret mode at S
  13 x G 7 and S 17 x G 8, head_dim 128 and 256, bf16 and int8 pages, with
  ``tests/test_torch_verify.py``'s tolerances.
* Every preset at every ``spec_draft`` 0-16 and bf16 and int8 pages plans
  row tiles the kernels take (a block's shared memory within the card:
  Gemma-2B's CUDA-core body at head_dim 256 needs ~2.2 KB a row), and K3's
  wrapper takes ranks 128 and 200 (its launch through a stand-in library).
* A QLoRA ``Trainer.train`` at rank 128 over an int4 base against the live
  JAX trainer (its K3 interpreted), and a greedy refill round at
  ``spec_draft=12`` with 8 query heads over 1 kv head (104 query rows)
  against the JAX engine, token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrl_llm_tpu import trainer as jtrainer
from distrl_llm_tpu.config import SamplingConfig as JSamplingConfig
from distrl_llm_tpu.engine import paged_engine as jpe
from distrl_llm_tpu.engine.fake import FakeEngine as JFakeEngine
from distrl_llm_tpu.models import lora as jlora
from distrl_llm_tpu.models import transformer as jtf
from distrl_llm_tpu.models.configs import TINY
from distrl_llm_tpu.ops import paged as jpaged
from distrl_llm_tpu.ops import paged_native as jnative
from distrl_llm_tpu.ops.quant_matmul import quant_matmul as jquant_matmul
from distrl_llm_tpu.rewards import reward_function as jreward_function
from distrl_llm_tpu.tokenizer import CharTokenizer as JCharTokenizer
from distrl_llm_tpu_torch import PagedGenerationEngine, trainer
from distrl_llm_tpu_torch.config import SamplingConfig
from distrl_llm_tpu_torch.engine.fake import FakeEngine
from distrl_llm_tpu_torch.models import configs as tconfigs
from distrl_llm_tpu_torch.models.configs import ModelConfig
from distrl_llm_tpu_torch.models.convert import lora_from_numpy, lora_to_numpy, params_from_numpy
from distrl_llm_tpu_torch.ops import paged_native as tnative
from distrl_llm_tpu_torch.ops import quant, quant_matmul as qmm
from distrl_llm_tpu_torch.rewards import reward_function
from distrl_llm_tpu_torch.tokenizer import CharTokenizer
from tests.test_torch_prefix_cache import _one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_quant import QMM_RTOL, _jax_q, _quantized_trees
from tests.test_torch_split_k import _FakeLib
from tests.test_torch_trainer import (
    _port_config, _Recorder, _check_adapters, _check_records, _np_tree,
)
from tests.test_torch_verify import ATOL, _setup
from tests.test_trainer import make_config, make_datasets, script

LOGP_ATOL = 1e-4  # tests/test_torch_refill_engine.py's, f32 pages


# ------------------------------------------------------------------- K3


def _qmm_case(bits, m, rank, *, k=128, n=96, group=32, seed=0):
    rng = np.random.default_rng(seed + 7 * m + bits + rank)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = quant.quantize(torch.from_numpy((0.05 * rng.standard_normal((k, n))).astype(np.float32)),
                       bits=bits, group_size=group if bits == 4 else None)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    a = (rng.standard_normal((k, rank)) / np.sqrt(k)).astype(np.float32)
    b = (0.1 * rng.standard_normal((rank, n))).astype(np.float32)
    return x, w, bias, a, b


@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8], ids=["int4_g32", "int8"])
@pytest.mark.parametrize("rank", [96, 128, 200, 256])
def test_k3_plain_version_matches_jax_past_rank_64(rank, bits, dtype, m):
    x, w, bias, a, b = _qmm_case(bits, m, rank)
    scale = 0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    want = np.asarray(jquant_matmul(jx, _jax_q(w), jnp.asarray(bias).astype(jdt),
                                    jnp.asarray(a), jnp.asarray(b), scale,
                                    interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    got = qmm.quant_matmul(tx, w, torch.from_numpy(bias).to(tdt), torch.from_numpy(a),
                           torch.from_numpy(b), scale)
    assert got.dtype == tdt and np.any(b)
    g = got.float().numpy()
    atol = QMM_RTOL * np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(g, want, atol=atol, rtol=0)
    else:
        mag = np.maximum(np.abs(g), np.abs(want))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
        assert (np.abs(g - want) <= 2 * ulp + atol).all()


@pytest.mark.parametrize("rank,chunks", [(1, 1), (32, 1), (33, 1), (64, 1), (65, 2), (96, 2),
                                         (128, 2), (200, 4), (256, 4), (1000, 16)])
def test_rank_plan_walks_any_rank_in_chunks(rank, chunks):
    tile, got = qmm.plan_rank(rank)
    assert got == chunks and tile == (32 if rank <= 32 else qmm.RANK_CHUNK)
    assert tile * (got - 1) < rank <= tile * got  # every column, no empty chunk
    assert qmm.plan_rank(0) == (0, 0)
    with pytest.raises(ValueError, match="rank"):
        qmm.plan_rank(-1)


@pytest.mark.parametrize("m", [64, 416, 600])
@pytest.mark.parametrize("rank", [128, 200])
def test_k3_wrapper_takes_ranks_above_64(monkeypatch, rank, m):
    """The wrapper's argument checks take ranks 128 and 200 (no ceiling):
    the launch gets the rank and the workspace the plan asks for (a split's
    partial x·A at the rank itself; one split's xa padded to whole chunks),
    bf16 and f32, through a stand-in library. The launch adds one to K3's
    count and one to its rank-chunk count."""
    fake = _FakeLib()
    allocated, empty = [], torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        allocated.append(t)
        return t

    monkeypatch.setattr(qmm, "_kernel_lib", lambda: fake)
    monkeypatch.setattr(qmm, "_stream", lambda device: 0)
    monkeypatch.setattr(qmm.torch, "empty", recording_empty)
    k, n = 256, 512
    g = torch.Generator().manual_seed(rank)
    w = quant.quantize(torch.randn(k, n, generator=g) * 0.02, bits=4, group_size=64)
    a, b = torch.randn(k, rank, generator=g), torch.randn(rank, n, generator=g)
    for dt in (torch.bfloat16, torch.float32):
        before = (qmm.quant_matmul_launches, qmm.quant_matmul_rank_chunks_launches)
        fake.calls.clear()
        allocated.clear()
        qmm.quant_matmul_launch(torch.randn(m, k, generator=g).to(dt), w, None, a, b, 0.5)
        (args,) = fake.calls
        assert args[13] == rank
        plan = (qmm.plan_split_k(m, k, n, 64) if dt == torch.bfloat16
                else qmm.SplitPlan(64, 128, 1, k, 0))
        want = plan.workspace_numel(m, n, rank, dt.itemsize)
        tile, chunks = qmm.plan_rank(rank)
        if plan.splits == 1:
            assert want == m * tile * chunks * dt.itemsize // 4
        (ws,) = [t for t in allocated if t.data_ptr() == args[7]]
        assert ws.numel() == want
        assert (qmm.quant_matmul_launches, qmm.quant_matmul_rank_chunks_launches) == (
            before[0] + 1, before[1] + 1)


# ------------------------------------------------------------------- K5


@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("s,g", [(13, 7), (17, 8)])
def test_k5_plain_version_matches_jax_past_64_rows(s, g, hd, pages):
    """S·G = 91 and 136 query rows of one kv head: f32 q over int8 pages
    within ATOL; bf16 q over bf16 pages within one bf16 ulp + ATOL."""
    q, kp, vp, lengths, table = _setup(b=2, s=s, h=g, kh=1, hd=hd, ps=16, pps=4,
                                       lengths=[1, 40], seed=s + hd)
    if pages == "int8":
        kq, vq = jpaged.quantize_pages(jnp.asarray(kp)), jpaged.quantize_pages(jnp.asarray(vp))
        w = [np.array(kq.weight), np.array(vq.weight)]
        sc = [np.array(kq.scales), np.array(vq.scales)]
        want = np.asarray(jnative.paged_attention_native_verify(
            jnp.asarray(q) * hd**-0.5, jnp.asarray(w[0]), jnp.asarray(w[1]),
            jnp.asarray(lengths), jnp.asarray(table), jnp.asarray(sc[0]), jnp.asarray(sc[1]),
            pages_per_block=2, interpret=True))
        got = tnative.paged_attention_native_verify(
            (torch.from_numpy(q) * hd**-0.5).contiguous(), torch.from_numpy(w[0]),
            torch.from_numpy(w[1]), torch.from_numpy(lengths), torch.from_numpy(table),
            torch.from_numpy(sc[0]), torch.from_numpy(sc[1]))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        return
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))  # noqa: E731
    qs = jnp.asarray(q, jnp.bfloat16) * jnp.asarray(hd**-0.5, jnp.bfloat16)
    want = np.asarray(jnative.paged_attention_native_verify(
        qs, jnp.asarray(bf(kp)), jnp.asarray(bf(vp)), jnp.asarray(lengths),
        jnp.asarray(table), pages_per_block=2, interpret=True)).astype(np.float32)
    def t(x):
        return torch.from_numpy(np.asarray(x).astype(np.float32)).to(torch.bfloat16)

    got = tnative.paged_attention_native_verify(
        t(qs), t(bf(kp)), t(bf(vp)), torch.from_numpy(lengths), torch.from_numpy(table))
    g_ = got.float().numpy()
    mag = np.maximum(np.abs(g_), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
    assert (np.abs(g_ - want) <= ulp + ATOL).all()


PRESETS = sorted(tconfigs.PRESETS.items())


@pytest.mark.parametrize("name,cfg", PRESETS, ids=[n for n, _ in PRESETS])
def test_every_preset_and_draft_length_plans_tiles_the_kernels_take(name, cfg):
    """At every spec_draft 0-16 (d = 0: K2's G rows; else K5's (d + 1) · G)
    and bf16 and int8 pages under bf16 q, the geometry check passes, and its
    row tiles cover every query row with at most 64 a block, none empty,
    each block's shared memory within the card (Gemma-2B's head_dim 256
    included). The f32 engine (f32 q and pages) too."""
    g = cfg.num_heads // cfg.num_kv_heads
    pairs = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
             (torch.float32, torch.float32)]
    for d in range(17):
        rows = (d + 1) * g
        for q_dtype, kv_dtype in pairs:
            route = tnative._check_kernel_geometry(rows, cfg.head_dim, q_dtype, kv_dtype)
            tiles = tnative.plan_row_tiles(rows, cfg.head_dim, q_dtype, kv_dtype)
            assert tiles.rows <= tnative.MAX_ROWS
            assert tiles.rows * (tiles.tiles - 1) < rows <= tiles.rows * tiles.tiles
            assert tiles.tiles == -(-rows // tnative.MAX_ROWS) or kv_dtype == torch.float32
            smem = tnative.smem_bytes(tiles.rows, cfg.head_dim, q_dtype, kv_dtype)
            assert smem <= tnative._SMEM_LIMIT, (name, d, q_dtype, kv_dtype, smem)
            if route == "mma":
                mt, warps = tnative.mma_layout(tiles.rows)
                assert mt <= 4 and warps <= 12
    # the largest verify block over the presets: 17 x 8 = 136 rows, 3 tiles
    assert tnative.plan_row_tiles(136, 256, torch.bfloat16, torch.bfloat16) == (
        tnative.RowTiles(3, 46))


# ------------------------------------------------------- trainer, refill


def test_qlora_trainer_at_rank_128_matches_jax(monkeypatch):
    """Both trainers on the FakeEngine script over one int4 g16 TINY base
    (the JAX trainer's K3 interpreted), rank 128, the port's initial adapter
    the JAX trainer's: metric records, losses and the adapter after each of
    two steps within the learner's tolerances (tests/test_torch_trainer.py)."""
    monkeypatch.setenv("DISTRL_QUANT_MATMUL", "interpret")
    jparams, tree = _quantized_trees(4, group=16)
    cfg_kw = dict(learner="pg", topk=4, max_lora_rank=128, base_quant="int4",
                  quant_group_size=16)
    train, test = make_datasets()
    jtr = jtrainer.Trainer(train, test, jreward_function, make_config(**cfg_kw),
                           tokenizer=JCharTokenizer(),
                           engine=JFakeEngine(JCharTokenizer(), script, max_new_tokens=24),
                           base_params=jparams, model_cfg=TINY)
    model = params_from_numpy(tree, ModelConfig(**dataclasses.asdict(TINY)), device="cpu")
    tr = trainer.Trainer(train, test, reward_function, _port_config(**cfg_kw),
                         tokenizer=CharTokenizer(),
                         engine=FakeEngine(CharTokenizer(), script, max_new_tokens=24), model=model)
    assert tr.lora["layers"]["wq"]["a"].shape[-1] == 128
    j0 = _np_tree(jtr.lora)
    with torch.no_grad():
        for t, ab in tr.lora["layers"].items():
            for k, x in ab.items():
                x.copy_(torch.tensor(j0["layers"][t][k]))
    jtr.sink = _Recorder(lambda: _np_tree(jtr.lora))
    tr.sink = _Recorder(lambda: lora_to_numpy(tr.lora))
    jtr.train()
    tr.train()
    _check_records(jtr.sink.records, tr.sink.records)
    _check_adapters(tr, jtr)
    assert tr.weight_version == jtr.weight_version == 2


def test_spec_refill_at_104_query_rows_matches_jax():
    """A greedy refill round at spec_draft 12 on TINY's width with 8 query
    heads over 1 kv head (13 x 8 = 104 query rows a verify block), f32
    pages, 4 slots for 8 candidates: tokens and lengths equal the JAX
    engine's, logprobs within LOGP_ATOL; drafts are accepted."""
    jcfg = dataclasses.replace(TINY, num_heads=8, num_kv_heads=1)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tree = _np_tree(jtf.init_params(jax.random.PRNGKey(3), jcfg))
    lora = _np_tree(jlora.init_lora_params(jax.random.PRNGKey(4), jcfg, 4))
    rng = np.random.default_rng(4)
    for ab in lora["layers"].values():
        ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    p, t, n = 16, 24, 2
    ids = np.zeros((4, p), np.int32)
    mask = np.zeros((4, p), np.int32)
    for i, length in enumerate((5, 9, 16, 12)):
        ids[i, p - length:] = rng.integers(4, jcfg.vocab_size, length)
        mask[i, p - length:] = 1
    common = dict(max_prompt_tokens=p, max_new_tokens=t, eos_token_ids=[999], pad_token_id=0,
                  lora_scale=0.5, capture_logprobs=True, page_size=8, scheduler="refill",
                  max_concurrent_rows=4, spec_draft=12)
    jeng = jpe.PagedGenerationEngine(jcfg, cache_dtype=jnp.float32, autotune=False,
                                     scan_chunk=0, paged_impl="reference", **common)
    teng = PagedGenerationEngine(cfg, cache_dtype=torch.float32, device="cpu", **common)
    jres = jeng.generate(jax.tree_util.tree_map(jnp.asarray, tree),
                         jax.tree_util.tree_map(jnp.asarray, lora), ids, mask,
                         JSamplingConfig(max_tokens=t, temperature=0.0, n=n),
                         jax.random.PRNGKey(0))
    tres = teng.generate(params_from_numpy(tree, cfg, device="cpu"),
                         lora_from_numpy(lora, cfg, device="cpu"), ids, mask,
                         SamplingConfig(max_tokens=t, temperature=0.0, n=n), 0)
    np.testing.assert_array_equal(tres.tokens, jres.tokens)
    np.testing.assert_array_equal(tres.lengths, jres.lengths)
    np.testing.assert_allclose(tres.logprobs, jres.logprobs, atol=LOGP_ATOL, rtol=0)
    assert teng.last_spec_stats["accept_rate"] > 0


def test_chip_smoke_domain_phase_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's phase 14 at TINY on the CPU (the plain versions, no
    launch counts): (a) the QLoRA trainer at rank 128 with spec_draft 12 and
    decode_scan_chunk 16, the initial eval and two steps, checked as on the
    card; (b) speculative vs plain refill at 104 query rows, tokens equal,
    drafts accepted. And K3's rank stanza and K5's row-tile stanza run
    their inputs through the plain versions."""
    import chip_smoke

    out = chip_smoke.domain_rehearsal(tmp_path)
    assert len(out["a"]["train_rounds"]) == 2
    assert out["b"]["spec"]["spec"]["accept_rate"] > 0
    res = chip_smoke.compare_quant_matmul_ranks("cpu", 0, ranks=(72,), shapes=(
        (64, 64), (64, 32), (64, 128), (128, 64)), rows=(8, 20), group=16, edge_k=64)
    assert res["f32_abs"] == 0 and all(err == 0 for _, err, _ in res["bf16"])
    err = chip_smoke.compare_paged_verify_tiles("cpu", 0, shapes=((5, 14, 1, 16),))
    assert err == 0
