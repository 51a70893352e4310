"""Causal self-attention with key padding and native GQA: the hand-written
Hopper kernel K4 (forward and backward) and its plain PyTorch version.

K4 (``csrc/flash_attention.cu``) replaces the TPU kernels the JAX package
reaches for learner and prefill attention: jaxlib's Pallas flash kernel
behind ``ops/flash_attention.py::flash_attention`` (K/V repeated to H heads,
custom-VJP ``_flash_attention_bwd_dkv`` / ``_bwd_dq``) and jaxlib's splash
kernel behind ``ops/splash.py::splash_attention`` (GQA native,
``_splash_attention_fwd`` / ``_bwd_dq`` / ``_bwd_dkv``). Both compute one
function, so the port has one kernel for ``attn_impl`` "flash" and "splash":

    out[b, i, h] = softmax_j(scale · q[b, i, h] · k[b, j, h // G]) · v

over the keys ``j <= i`` with ``key_valid[b, j]`` (exactly the mask of
``ops/attention.py::causal_padding_mask``), q ``[B, S, H, hd]``, k/v ``[B, S,
K, hd]``, G = H / K. ``scale`` (default ``hd**-0.5``) multiplies the f32
scores; the softmax runs in f32 and the output has q's dtype. The backward
returns dq, dk, dv in the input dtype, accumulated in f32; dk and dv sum
over each kv head's G query heads; ``key_valid`` gets no grad.

**Rows with no valid key** (left-pad positions before a row's first real
token) give 0, and contribute 0 to the backward, with no NaN anywhere. The
JAX reference gives such a row a uniform average over all keys, and splash
lets pad queries attend pad keys: the three disagree there. The learner
never reads these rows as long as the prompt is non-empty: its logits
slice starts at the prompt's last position, which is real.

``flash_attention`` launches K4 (forward, and backward through a
``torch.autograd.Function``) on CUDA tensors or raises, never falling back;
on CPU tensors it runs ``flash_attention_reference``. Each forward launch
adds one to ``flash_attention_fwd_launches``, each backward call (delta,
dk/dv and dq kernels) one to ``flash_attention_bwd_launches``; at head_dim
256 also one to its route's ``flash_attention_hd256_{bf16,f32}_{fwd,bwd}_
launches``. Head dims 64, 128 and 256 (every preset's) are built;
``check_kernel_domain`` refuses the rest.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distrl_llm_tpu_torch.ops import launch_count
from distrl_llm_tpu_torch.ops.attention import NEG_INF

#: launches of the CUDA forward / backward; CPU calls, which run the plain
#: version, do not count
flash_attention_fwd_launches = 0
flash_attention_bwd_launches = 0
#: the same launches at head_dim 256 (the Gemma family), by route: each of
#: these four also counts in the two above
flash_attention_hd256_bf16_fwd_launches = 0
flash_attention_hd256_bf16_bwd_launches = 0
flash_attention_hd256_f32_fwd_launches = 0
flash_attention_hd256_f32_bwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128, 256)  # the head dims the kernel is built for


def check_kernel_domain(q: torch.Tensor) -> None:
    """Raise ``ValueError`` where K4 is not built for q's head dim (the
    kernel itself refuses, with a CUDA error, an S whose key-tile lists
    would take a block past its shared memory)."""
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"K4 is built for head_dim in {KERNEL_HEAD_DIMS}, got {q.shape[-1]}")


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              key_valid: torch.Tensor,
                              scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of K4, differentiable by autograd, on whatever
    device the inputs are: scores, softmax and the PV product in f32 (masked
    scores at ``NEG_INF``), rows with no valid key set to exactly 0, one cast
    to q's dtype at the end."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    if scale is None:
        scale = d**-0.5
    qf = q.float().reshape(b, s, kh, g, d)
    scores = torch.einsum("bikgd,bjkd->bkgij", qf, k.float()) * scale
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] <= pos[:, None])[None] & key_valid.bool()[:, None, :]  # [B, Sq, Sk]
    mask = mask[:, None, None]
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    probs = probs * mask.any(dim=-1, keepdim=True)  # rows with no valid key -> 0
    out = torch.einsum("bkgij,bjkd->bikgd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def _check_args(q, k, v, key_valid) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be [B, S, H, hd] and k, v [B, S, K, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[:2] != q.shape[:2] or k.shape[3] != d:
        raise ValueError(f"k and v must be [{b}, {s}, K, {d}], got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    kh = k.shape[2]
    if kh < 1 or h % kh:
        raise ValueError(f"H={h} not divisible by K={kh}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(key_valid.shape) != (b, s):
        raise ValueError(f"key_valid must be [{b}, {s}], got {tuple(key_valid.shape)}")
    if any(t.device != q.device for t in (k, v, key_valid)):
        raise ValueError("all inputs must be on one device")


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (builds at
    first use; see ops/_build.py)."""
    from distrl_llm_tpu_torch.ops import _build

    lib = _build.load("flash_attention").lib
    if lib.flash_attention_fwd.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, f32, i32, i32, ptr]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_bwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, f32, i32, i32, ptr]
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention {what} kernel launch failed: {msg} ({err})")


def _cuda_checks(tensors) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention's kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention's kernel takes 16-byte aligned tensors")


def _count_hd256(q: torch.Tensor, part: str) -> None:
    if q.shape[-1] == 256:
        name = f"flash_attention_hd256_{'bf16' if q.dtype == torch.bfloat16 else 'f32'}_{part}"
        launch_count.add(__name__, f"{name}_launches")


def flash_attention_forward(q, k, v, valid, scale: float):
    """One launch of K4's forward on CUDA tensors (q, k, v contiguous, one
    dtype; ``valid`` int32 [B, S]) → (out like q, lse f32 [B, H, S])."""
    b, s, h, d = q.shape
    _cuda_checks((q, k, v, valid))
    lib = _kernel_lib()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, k.shape[2], d, scale, _DTYPE_CODES[q.dtype],
        q.device.index or 0, stream)
    _raise_on(lib, err, "forward")
    launch_count.add(__name__, "flash_attention_fwd_launches")
    _count_hd256(q, "fwd")
    return out, lse


def flash_attention_backward(q, k, v, valid, out, lse, dout, scale: float):
    """One call of K4's backward (its delta, dk/dv and dq kernels) on CUDA
    tensors → (dq, dk, dv) in the input dtype."""
    b, s, h, d = q.shape
    _cuda_checks((q, k, v, valid, out, lse, dout))
    lib = _kernel_lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, s, h, k.shape[2], d, scale, _DTYPE_CODES[q.dtype],
        q.device.index or 0, stream)
    _raise_on(lib, err, "backward")
    launch_count.add(__name__, "flash_attention_bwd_launches")
    _count_hd256(q, "bwd")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K4's forward and backward kernels as one autograd node."""

    @staticmethod
    def forward(ctx, q, k, v, valid, scale):
        out, lse = flash_attention_forward(q, k, v, valid, scale)
        ctx.save_for_backward(q, k, v, valid, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, valid, out, lse,
                                              dout.contiguous(), ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Causal GQA self-attention with key padding: q [B, S, H, hd], k/v [B,
    S, K, hd] (f32 or bf16, one dtype), key_valid [B, S] (int or bool) →
    [B, S, H, hd] in q's dtype, differentiable in q, k and v. On CUDA
    tensors: K4's forward (and, under autograd, its backward), or an
    exception, never a fallback. On CPU tensors: the plain version."""
    _check_args(q, k, v, key_valid)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_valid, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    check_kernel_domain(q)
    valid = key_valid.to(torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, valid, float(scale))
