"""The learner update: a grad-accumulated PG/GRPO step.

Counterpart of the JAX package's ``learner/train_step.py``. Where the JAX
step is one jitted ``lax.scan`` over microbatches, the port runs a Python
loop: each microbatch's weighted loss is backpropagated into the adapter
leaves' ``.grad`` (summed across microbatches), the sum is divided by the
count of microbatches that hold a real row, and the optimizer takes one
step in place.

* The zero-reward skip is a weight on the microbatch loss (``skip_semantics``
  "all_zero": skip when every real coefficient is 0; "any_zero": when any
  is, the reference's bug-parity). A skipped microbatch still counts in the
  divisor; a padding-only one does not. A microbatch of weight 0 adds
  exactly 0 to the loss and the grads, so the port runs no backward for it
  (and, unless the dynamics are asked for, no forward either).
* ``loss_sum`` is the sum of the weighted microbatch losses.
* ``emit_dynamics`` adds the training-dynamics bundle: masked answer-token
  entropy, behavior↔policy KL and the importance-ratio histogram (when the
  batch carries behavior logprobs), clip/cap fractions, advantage moments
  and grad norms by depth group.

Batch layout (``prepare_update_batch``): all tensors lead with N =
num_micro · micro_size; rows past the real sample count are padding with
``sample_mask`` 0.

On a learner mesh (``mesh=``, ``parallel/mesh.py``) the trained tree is a
``ShardedLora`` or ``ShardedDecoder`` (``parallel/partition.py``): each
microbatch gathers the whole adapter (full fine-tuning: each layer gathers
its weights in its forward), so every kernel sees whole local tensors, and
the backward leaves each rank its range of the grads. The rows go over dp
by whole microbatches (``prepare_update_batch(mesh=)``): each dp group runs
its own microbatches, and the grads, the count of real microbatches and
the loss are summed over dp before the division, which is the global-batch
mean JAX's ``psum`` gives (the reference's multi-learner gradient merge,
SURVEY §3.4).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from distrl_llm_tpu_torch.learner.losses import (
    answer_logprobs, grpo_aipo_loss, grpo_clip_loss, grpo_loss, kl_to_ref,
    pg_loss,
)
from distrl_llm_tpu_torch.models.transformer import Decoder
from distrl_llm_tpu_torch.ops.linear import dropout_stream
from distrl_llm_tpu_torch.tokenizer import encode_fixed
from distrl_llm_tpu_torch.utils.device import resolve_device

# the IS-ratio histogram pre-bins over the JAX package's telemetry bucket
# ladder (its telemetry.HIST_BUCKET_BOUNDS), one overflow slot past the end
_RATIO_BOUNDS: tuple[float, ...] = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)
_GRAD_DEPTH_BUCKETS = 4  # LoRA grad-norm depth groups (a0..a3 / b0..b3)

_ITEM_10B = "ROADMAP queue 1 item 10b: tensor and sequence parallelism"


class UpdateBatch(NamedTuple):
    """Fixed-shape flattened candidates for one policy update."""

    prompt_ids: torch.Tensor  # [N, P] int32, left-padded
    prompt_mask: torch.Tensor  # [N, P]
    answer_ids: torch.Tensor  # [N, T] int32, right-padded
    answer_mask: torch.Tensor  # [N, T]
    coeffs: torch.Tensor  # [N] f32 — reward−baseline (PG) or advantage (GRPO)
    sample_mask: torch.Tensor  # [N] f32 — 0 for padding rows
    behavior_logps: torch.Tensor | None = None  # [N, T] engine logprobs
    version_lag: torch.Tensor | None = None  # [N, T] policy-version lag
    loss_mask: torch.Tensor | None = None  # [N, T] policy spans (multi-turn)


def _microbatch_dynamics(logps, entropy, mb: UpdateBatch, *, clip_ratio: float,
                         off_policy: str, is_cap: float) -> dict:
    """Per-microbatch training-dynamics SUMS, detached from the graph;
    ``_derive_dynamics`` normalizes them after the loop."""
    logps = logps.detach()
    train_mask = mb.answer_mask if mb.loss_mask is None else mb.loss_mask
    mask = train_mask.float() * mb.sample_mask[:, None]
    real = mb.sample_mask
    dyn = {
        "tok_count": mask.sum(),
        "entropy_sum": (entropy.detach() * mask).sum(),
        "adv_count": real.sum(),
        "adv_sum": (mb.coeffs * real).sum(),
        "adv_sq_sum": (torch.square(mb.coeffs) * real).sum(),
        "adv_pos": ((mb.coeffs > 0.0).float() * real).sum(),
    }
    if mb.behavior_logps is not None:
        # k3 KL with the exponent zeroed at pads before exp
        diff = (mb.behavior_logps - logps) * mask
        dyn["kl_sum"] = ((torch.exp(diff) - diff - 1.0) * mask).sum()
        ratio = torch.exp((logps - mb.behavior_logps) * mask)
        bounds = torch.tensor(_RATIO_BOUNDS, dtype=torch.float32, device=ratio.device)
        idx = torch.searchsorted(bounds, ratio.contiguous(), right=False)
        onehot = torch.nn.functional.one_hot(idx, len(_RATIO_BOUNDS) + 1).float()
        dyn["ratio_counts"] = (onehot * mask[..., None]).sum((0, 1))
        if clip_ratio > 0.0 and off_policy == "aipo":
            dyn["cap_count"] = ((ratio >= is_cap).float() * mask).sum()
        elif clip_ratio > 0.0:
            dyn["clip_count"] = (((ratio - 1.0).abs() > clip_ratio).float() * mask).sum()
    return dyn


def _grad_norm_groups(grads, train_mode: str,
                      n_buckets: int = _GRAD_DEPTH_BUCKETS) -> dict:
    """Whole-tree grad norm, plus — for the LoRA tree ``{"layers": {target:
    {"a": [L, …], "b": [L, …]}}}`` — per-group norms split A vs B and
    bucketed over the layer axis into ``n_buckets`` depth groups (summed
    across targets, split as ``np.array_split``)."""
    leaves = _leaves(grads)
    out = {"grad_norm_total": torch.sqrt(sum(torch.square(g.float()).sum() for g in leaves))}
    # a full tree's grads are a list of its parameters' grads: the total only
    layers = grads.get("layers") if train_mode == "lora" and isinstance(grads, dict) else None
    if not layers:
        return out
    for ab in ("a", "b"):
        per_layer = None  # [L] sum of squares across targets
        for target in layers.values():
            if ab not in target:
                continue
            g = target[ab].float()
            sq = torch.square(g).sum(dim=tuple(range(1, g.dim())))
            per_layer = sq if per_layer is None else per_layer + sq
        if per_layer is None:
            continue
        n = min(n_buckets, per_layer.shape[0])
        for i, seg in enumerate(torch.tensor_split(per_layer, n)):
            out[f"grad_norm_{ab}{i}"] = torch.sqrt(seg.sum())
    return out


def _derive_dynamics(sums, grads, *, train_mode: str) -> dict:
    """Normalize the accumulated sums into the published bundle."""
    tok = torch.clamp(sums["tok_count"], min=1.0)
    nadv = torch.clamp(sums["adv_count"], min=1.0)
    adv_mean = sums["adv_sum"] / nadv
    adv_var = torch.clamp(sums["adv_sq_sum"] / nadv - torch.square(adv_mean), min=0.0)
    dyn = {
        "entropy": sums["entropy_sum"] / tok,
        "tokens": sums["tok_count"],
        "adv_mean": adv_mean,
        "adv_std": torch.sqrt(adv_var),
        "adv_pos_frac": sums["adv_pos"] / nadv,
    }
    if "kl_sum" in sums:
        dyn["kl"] = sums["kl_sum"] / tok
        dyn["ratio_counts"] = sums["ratio_counts"]
    if "cap_count" in sums:
        dyn["cap_frac"] = sums["cap_count"] / tok
    if "clip_count" in sums:
        dyn["clip_frac"] = sums["clip_count"] / tok
    dyn.update(_grad_norm_groups(grads, train_mode))
    return dyn


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, Decoder):  # full fine-tuning: every parameter trains
        return list(tree.parameters())
    return [tree]


def _microbatch_weight(mb: UpdateBatch, skip_semantics: str) -> tuple[float, float]:
    """(weight, has_real) of a microbatch, decided by its coefficients on
    the host: the skip tests coeffs (baseline-subtracted rewards or
    advantages), as the reference does."""
    real = mb.sample_mask > 0
    if skip_semantics == "any_zero":  # reference bug-parity (.all()==0)
        skip = bool((real & (mb.coeffs == 0.0)).any())
    else:  # "all_zero", the documented intent
        skip = not bool((real & (mb.coeffs != 0.0)).any())
    has_real = bool(real.any())
    return (0.0 if skip or not has_real else 1.0), float(has_real)


def _microbatch_loss(lora, base: Decoder, mb: UpdateBatch, *, learner_type: str,
                     lora_scale: float, remat: bool, attn_impl: str,
                     lora_dropout: float = 0.0, dropout_seed: int | None = None,
                     logit_chunk: int = 0, clip_ratio: float = 0.0,
                     kl_coeff: float = 0.0, off_policy: str = "clip",
                     is_cap: float = 2.0, max_staleness: int = 0,
                     emit_dynamics: bool = False, train_mode: str = "lora"):
    """Loss of one microbatch (unweighted) and, with ``emit_dynamics``, its
    dynamics sums. ``train_mode="full"``: ``lora`` IS the trainable
    ``Decoder`` and ``base`` is ignored."""
    if train_mode == "full":
        out = answer_logprobs(
            lora, mb.prompt_ids, mb.prompt_mask, mb.answer_ids, mb.answer_mask,
            lora=None, remat=remat, attn_impl=attn_impl, logit_chunk=logit_chunk,
            return_entropy=emit_dynamics)
    else:
        out = answer_logprobs(
            base, mb.prompt_ids, mb.prompt_mask, mb.answer_ids, mb.answer_mask,
            lora=lora, lora_scale=lora_scale, remat=remat, attn_impl=attn_impl,
            lora_dropout=lora_dropout, dropout_seed=dropout_seed,
            logit_chunk=logit_chunk, return_entropy=emit_dynamics)
    logps, entropy = out if emit_dynamics else (out, None)
    # loss terms mask on POLICY spans only; answer_mask stays the attention mask
    loss_m = (mb.answer_mask if mb.loss_mask is None else mb.loss_mask).float()
    if clip_ratio > 0.0 and off_policy == "aipo":
        loss = grpo_aipo_loss(logps, mb.behavior_logps, loss_m, mb.coeffs, mb.sample_mask,
                              is_cap=is_cap, version_lag=mb.version_lag,
                              max_staleness=max_staleness)
    elif clip_ratio > 0.0:
        loss = grpo_clip_loss(logps, mb.behavior_logps, loss_m, mb.coeffs, mb.sample_mask,
                              clip_ratio=clip_ratio)
    else:
        loss_fn = grpo_loss if learner_type == "grpo" else pg_loss
        loss = loss_fn(logps, loss_m, mb.coeffs, mb.sample_mask)
    if kl_coeff > 0.0:
        # π_ref = the frozen base (no adapter): one extra forward, no grad
        with torch.no_grad():
            ref_logps = answer_logprobs(
                base, mb.prompt_ids, mb.prompt_mask, mb.answer_ids, mb.answer_mask,
                lora=None, remat=False, attn_impl=attn_impl, logit_chunk=logit_chunk)
        loss = loss + kl_coeff * kl_to_ref(logps, ref_logps, loss_m, mb.sample_mask)
    dyn = (_microbatch_dynamics(logps, entropy, mb, clip_ratio=clip_ratio,
                                off_policy=off_policy, is_cap=is_cap)
           if emit_dynamics else None)
    return loss, dyn


def make_train_step(
    cfg,
    *,
    learner_type: str = "pg",
    optimizer: torch.optim.Optimizer,
    lora_scale: float,
    micro_size: int,
    skip_semantics: str = "all_zero",
    remat: bool = True,
    attn_impl: str = "reference",
    attn_mesh=None,
    mesh=None,
    lora_dropout: float = 0.0,
    logit_chunk: int = 0,
    train_mode: str = "lora",
    clip_ratio: float = 0.0,
    kl_coeff: float = 0.0,
    off_policy: str = "clip",
    is_cap: float = 2.0,
    max_staleness: int = 0,
    emit_dynamics: bool = False,
) -> Callable:
    """Build the train step.

    Returns ``step(lora, base, batch, dropout_seed=None)``: ``lora`` is the
    adapter dict whose f32 leaves ``optimizer`` was built over (updated in
    place), ``base`` the frozen ``Decoder``. ``train_mode="full"`` (the JAX
    package's full-rank mode): ``lora`` is the trainable ``Decoder`` itself
    (every parameter with ``requires_grad``, the optimizer built over them)
    and ``base`` is None. It returns ``loss_sum`` (a 0-dim f32 tensor), or
    ``(loss_sum, dynamics)`` with ``emit_dynamics``. ``dropout_seed`` (LoRA
    dropout) is drawn anew by the caller per step; each microbatch, layer
    and target derives its own mask seed from it.

    ``mesh`` (the learner ``RoleMesh``): ``lora`` is the sharded tree and
    ``batch`` this rank's rows (``prepare_update_batch(mesh=)``); the grads,
    the real-microbatch count and the loss are summed over the dp group.
    Every rank of the mesh must call the step."""
    if train_mode not in ("lora", "full"):
        raise ValueError(f"train_mode must be 'lora' or 'full', got {train_mode!r}")
    if train_mode == "full" and kl_coeff > 0.0:
        # full mode has no frozen base to serve as the reference policy
        raise ValueError("kl_coeff requires train_mode='lora' (frozen base = ref)")
    if attn_mesh is not None:
        raise NotImplementedError(f"attn_mesh (ring/ulysses) is not ported yet ({_ITEM_10B})")
    if mesh is not None and emit_dynamics:
        raise ValueError("emit_dynamics reads whole grads; a learner mesh keeps shards")
    dp_group = mesh.group("dp") if mesh is not None and mesh.device_mesh is not None else None
    if off_policy not in ("clip", "aipo"):
        raise ValueError(f"off_policy must be 'clip' or 'aipo', got {off_policy!r}")
    kw = dict(learner_type=learner_type, lora_scale=lora_scale, remat=remat,
              attn_impl=attn_impl, lora_dropout=lora_dropout, logit_chunk=logit_chunk,
              clip_ratio=clip_ratio, kl_coeff=kl_coeff, off_policy=off_policy,
              is_cap=is_cap, max_staleness=max_staleness, emit_dynamics=emit_dynamics,
              train_mode=train_mode)

    def step(lora, base: Decoder | None, batch: UpdateBatch,
             dropout_seed: int | None = None):
        model = lora if train_mode == "full" else base
        if model.cfg != cfg:
            raise ValueError("the model's config does not match the step's")
        n = batch.prompt_ids.shape[0]
        if n % micro_size:
            raise ValueError(f"batch {n} not divisible by micro {micro_size}")
        num_micro = n // micro_size
        # on a learner mesh the tree is ``shard_tree``'s: its shards train
        leaves = lora.trainable() if mesh is not None else _leaves(lora)
        for p in leaves:
            p.grad = None
        dev = batch.coeffs.device
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        num_real = 0.0
        sums = None
        # this rank's microbatches are the global ones from first_micro on
        first_micro = mesh.coordinate()[0] * num_micro if mesh is not None else 0
        for i in range(num_micro):
            mb = UpdateBatch(*(None if x is None else x[i * micro_size:(i + 1) * micro_size]
                               for x in batch))
            weight, has_real = _microbatch_weight(mb, skip_semantics)
            num_real += has_real
            seed = (dropout_stream(dropout_seed, first_micro + i)
                    if dropout_seed is not None else None)
            if weight == 0.0 and not emit_dynamics:
                continue  # adds exactly 0 to the loss and the grads
            # a sharded adapter is gathered whole for each microbatch (its
            # backward keeps this rank's ranges); a sharded model gathers
            # its layers itself
            trained = lora.gather() if mesh is not None and train_mode == "lora" else lora
            with torch.set_grad_enabled(weight != 0.0):
                loss, dyn = _microbatch_loss(trained, base, mb, dropout_seed=seed, **kw)
            if weight != 0.0:
                loss.backward()
                loss_sum = loss_sum + loss.detach()
            if emit_dynamics:
                sums = dyn if sums is None else {k: sums[k] + dyn[k] for k in sums}
        with torch.no_grad():
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if dp_group is not None:
                # the gradient merge: each dp group's sums over its rows,
                # summed over dp, then divided once as one rank divides
                real = torch.tensor([num_real], dtype=torch.float32, device=dev)
                for t in (real, loss_sum, *(p.grad for p in leaves)):
                    torch.distributed.all_reduce(t, group=dp_group)
                num_real = float(real.item())
            # reference scaling: each microbatch contributes grad/num_batches;
            # num_batches counts microbatches with real rows, skipped or not
            denom = max(num_real, 1.0)
            for p in leaves:
                p.grad.div_(denom)
        dynamics = None
        if emit_dynamics:
            grads = ([p.grad for p in leaves] if train_mode == "full"
                     else _tree_map(lambda p: p.grad, lora))
            dynamics = _derive_dynamics(sums, grads, train_mode=train_mode)
        optimizer.step()
        for p in leaves:
            p.grad = None
        return (loss_sum, dynamics) if emit_dynamics else loss_sum

    return step


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _bucket_width(mask, buckets, cap: int) -> int:
    """Smallest bucket holding the longest real row of ``mask`` (row length
    = mask sum), capped at ``cap``; ``cap`` when no bucket is large enough."""
    lens = np.asarray(mask).sum(axis=1)
    need = max(1, int(lens.max()) if lens.size else 1)
    return min(next((b for b in sorted(buckets) if b >= need), cap), cap)


def prepare_update_batch(
    tokenizer,
    problems: list[str],
    answers: list[str],
    coeffs: np.ndarray,
    *,
    max_prompt_tokens: int,
    max_new_tokens: int,
    micro_size: int,
    mesh=None,
    raw_rollout: dict | None = None,
    answer_buckets: Sequence[int] | None = None,
    prompt_buckets: Sequence[int] | None = None,
    current_version: int | None = None,
    device: str | torch.device | None = None,  # None = the GPU
) -> UpdateBatch:
    """Host-side tokenize+pad to the fixed learner shapes, then one copy to
    ``device``: prompts left-padded/truncated to ``max_prompt_tokens``,
    answers right-padded/truncated to ``max_new_tokens`` (or the engine's
    own tokens and behavior logprobs from ``raw_rollout``), rows padded up
    to a multiple of ``micro_size`` with ``sample_mask`` 0. ``answer_buckets``
    / ``prompt_buckets`` cut all-masked columns to the smallest bucket that
    holds the longest real row. ``mesh``: this rank's rows
    (``place_update_batch``)."""
    arrays = update_arrays(
        tokenizer, problems, answers, coeffs, max_prompt_tokens=max_prompt_tokens,
        max_new_tokens=max_new_tokens, raw_rollout=raw_rollout,
        answer_buckets=answer_buckets, prompt_buckets=prompt_buckets,
        current_version=current_version)
    return place_update_batch(arrays, micro_size=micro_size, device=device, mesh=mesh)


def update_arrays(
    tokenizer,
    problems: list[str],
    answers: list[str],
    coeffs: np.ndarray,
    *,
    max_prompt_tokens: int,
    max_new_tokens: int,
    raw_rollout: dict | None = None,
    answer_buckets: Sequence[int] | None = None,
    prompt_buckets: Sequence[int] | None = None,
    current_version: int | None = None,
) -> dict:
    """The update batch's host arrays by ``UpdateBatch`` field, one row per
    real sample (None where a field is absent): what rank 0 hands the
    learner ranks."""
    n_real = len(problems)
    prompt_ids, prompt_mask = encode_fixed(tokenizer, problems, max_prompt_tokens, side="left")
    if prompt_buckets:
        p_width = _bucket_width(prompt_mask, prompt_buckets, max_prompt_tokens)
        if p_width < max_prompt_tokens:
            prompt_ids, prompt_mask = prompt_ids[:, -p_width:], prompt_mask[:, -p_width:]
    behavior_logps = version_lag = loss_mask = None
    if raw_rollout is not None:
        # train on the ENGINE'S token ids: retokenizing the decoded text can
        # shift token boundaries and desync the behavior logprobs
        eng_tokens = np.asarray(raw_rollout["answer_tokens"], np.int32)
        eng_logps = np.asarray(raw_rollout["behavior_logps"], np.float32)
        width = min(eng_tokens.shape[1], max_new_tokens)
        answer_ids = np.zeros((n_real, max_new_tokens), np.int32)
        behavior = np.zeros((n_real, max_new_tokens), np.float32)
        answer_ids[:, :width] = eng_tokens[:, :width]
        behavior[:, :width] = eng_logps[:, :width]
        lengths = np.minimum(np.asarray(raw_rollout["lengths"], np.int32), width)
        answer_mask = (np.arange(max_new_tokens)[None, :] < lengths[:, None]).astype(np.int32)
        if "loss_mask" in raw_rollout:
            lm = np.zeros((n_real, max_new_tokens), np.int32)
            lm[:, :width] = np.asarray(raw_rollout["loss_mask"], np.int32)[:, :width]
            loss_mask = answer_mask * lm
        behavior_logps = behavior
        if current_version is not None and "version_tags" in raw_rollout:
            tags = np.asarray(raw_rollout["version_tags"], np.int32)
            version_lag = np.zeros((n_real, max_new_tokens), np.float32)
            version_lag[:, :width] = np.maximum(current_version - tags[:, :width], 0)
            version_lag *= loss_mask if loss_mask is not None else answer_mask
    else:
        answer_ids, answer_mask = encode_fixed(tokenizer, answers, max_new_tokens, side="right")
    if answer_buckets:
        width = _bucket_width(answer_mask, answer_buckets, max_new_tokens)
        if width < max_new_tokens:
            answer_ids, answer_mask = answer_ids[:, :width], answer_mask[:, :width]
            if behavior_logps is not None:
                behavior_logps = behavior_logps[:, :width]
            if version_lag is not None:
                version_lag = version_lag[:, :width]
            if loss_mask is not None:
                loss_mask = loss_mask[:, :width]
    return dict(
        prompt_ids=prompt_ids, prompt_mask=prompt_mask, answer_ids=answer_ids,
        answer_mask=answer_mask, coeffs=np.asarray(coeffs, np.float32),
        sample_mask=np.ones(n_real, np.float32), behavior_logps=behavior_logps,
        version_lag=version_lag, loss_mask=loss_mask)


def place_update_batch(arrays: dict, *, micro_size: int,
                       device: str | torch.device | None = None, mesh=None) -> UpdateBatch:
    """``update_arrays``' rows padded up to a multiple of ``micro_size``
    with ``sample_mask`` 0, copied to ``device``. ``mesh`` (the learner
    ``RoleMesh``): the rows are padded up to ``micro_size * dp`` and this
    rank gets its dp group's contiguous share, whole microbatches (JAX lays
    the rows over "dp" when their count divides by dp and keeps them
    replicated otherwise; the padding microbatches hold no real row, so
    they add nothing to the loss, the grads or the divisor, and the result
    is the same)."""
    dev = resolve_device(device)
    dp, d = 1, 0
    if mesh is not None:
        from distrl_llm_tpu_torch.parallel.partition import _check_mesh

        _check_mesh(mesh)
        dp, d = mesh.dp, mesh.coordinate()[0]
    n_real = len(arrays["coeffs"])
    unit = micro_size * dp
    n = -(-max(n_real, 1) // unit) * unit
    lo, hi = d * n // dp, (d + 1) * n // dp

    def put(x):
        if x is None:
            return None
        x = np.asarray(x)
        x = np.pad(x, ((0, n - n_real),) + ((0, 0),) * (x.ndim - 1))[lo:hi]
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return UpdateBatch(**{f: put(arrays[f]) for f in UpdateBatch._fields})
