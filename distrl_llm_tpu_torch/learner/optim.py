"""Adam with blockwise 8-bit dynamic-code moment state.

Counterpart of the JAX package's ``learner/optim.py`` (the reference's
``bnb.optim.Adam8bit``), written by hand in PyTorch: both Adam moments are
stored int8 with one absmax scale per block of 256 elements, dequantized
for the update and requantized after. The codes are DYNAMIC (exponent plus
linear fraction): the 127 magnitudes of ``_dynamic_table`` split across 7
decades, so an element far below its block's max never rounds to zero. The
second moment is stored as ``sqrt(nu)``, and the normalized update
``mu_hat / (sqrt(nu_hat) + eps)`` is clipped to ``±clip_normalized``.

The int8 codes equal the JAX package's bit for bit on the same inputs: the
decision table is searched in f32 (``searchsorted(..., right=True)``), ``|x|
/ scale`` divides two tensors (PyTorch's ``scalar / tensor`` rounds
otherwise), the bias corrections ``b ** count`` are taken in f32, and the
moment updates round as XLA's CPU backend fuses the JAX update: ``mu =
fma(1 − b1, g, b1·mu_old)`` and ``nu = fma((1 − b2)·g, g, b2·sqrt_nu_old²)``,
each a product plus a sum rounded once (``_fma``).

``Adam8bit`` is a ``torch.optim.Optimizer``: ``step()`` reads each
parameter's ``.grad`` and updates the parameter in place; ``state_dict()``
holds only tensors and numbers (the trainer's resume state).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

BLOCK = 256


def _dynamic_table() -> np.ndarray:
    """127 ascending magnitudes in (0, 1]: decade d (values f·10^−d,
    f ∈ [0.1, 1)) gets 2^(6−d) linear fraction levels — 64 in the top decade
    down to a single level at 1e-7. The max (1.0) is exactly representable
    so each block's absmax round-trips bit-exact."""
    mags: list[float] = []
    for d in range(7):
        n = 2 ** (6 - d)
        if d == 0:
            fr = np.linspace(0.1, 1.0, n)  # include 1.0
        else:
            fr = np.linspace(0.1, 1.0, n, endpoint=False)
        mags.extend((fr * 10.0**-d).tolist())
    table = np.sort(np.asarray(mags, np.float64))
    assert table.shape == (127,) and table[-1] == 1.0
    return table


_TABLE = _dynamic_table()
# decision boundaries: below mid(0) → code 0 (zero); else nearest table entry
_MIDS = np.concatenate(([_TABLE[0] / 2.0], (_TABLE[:-1] + _TABLE[1:]) / 2.0))
_LUT = np.concatenate(([0.0], _TABLE)).astype(np.float32)  # code → magnitude

# bump when the int8 code semantics change (v2 = dynamic LUT + sqrt-nu
# storage, the JAX package's format)
STATE_FORMAT = 2


@dataclass
class _Quantized:
    """int8 payload + per-block absmax scale; flat layout with tail padding."""

    q: torch.Tensor  # int8 [nblocks * BLOCK]
    scale: torch.Tensor  # f32 [nblocks]
    size: int  # original element count
    shape: tuple  # original shape


def _fma(a, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a · x + c`` rounded once, as a fused multiply-add (``a`` an f32
    tensor or a float, taken at f32): the product of two f32 values is exact
    in f64, the sum is rounded to f64 and then to f32 (a double rounding
    that differs from a true fma only when the f64 sum falls exactly on an
    f32 rounding boundary, ~2^-29 of cases)."""
    a = a.double() if torch.is_tensor(a) else float(np.float32(a))
    return (x.double() * a + c.double()).float()


def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(_MIDS.astype(np.float32), device=device),
            torch.as_tensor(_LUT, device=device))


def _quantize(x: torch.Tensor) -> _Quantized:
    """Signed dynamic code: q = sign·m, m ∈ {0..127} indexing ``_LUT``."""
    flat = x.reshape(-1).float()
    size = flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, (-size) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))[:, None]
    r = blocks.abs() / safe  # tensor / tensor: a true division, as XLA's
    mids, _ = _tables(x.device)
    m = torch.searchsorted(mids, r.contiguous(), right=True)
    q = (torch.sign(blocks) * m.float()).to(torch.int8)
    return _Quantized(q.reshape(-1), scale, size, tuple(x.shape))


def _dequantize(z: _Quantized) -> torch.Tensor:
    q = z.q.reshape(-1, BLOCK).to(torch.int32)
    _, lut = _tables(z.q.device)
    mag = lut[q.abs()]
    val = torch.sign(q.float()) * mag * z.scale[:, None]
    return val.reshape(-1)[: z.size].reshape(z.shape)


def _pieces(sizes: list[int], max_elems: int):
    """Cut a leaf of members of ``sizes`` elements (their flattened
    concatenation, in order) into chunks of at most ``max_elems`` elements
    (a multiple of ``BLOCK``) that start on a block boundary and, but for
    the last, end on one: lists of (member, lo, hi). A member that ends on a
    block boundary ends its chunk, so an aligned member is never copied."""
    chunk, start, off = [], 0, 0
    for i, n in enumerate(sizes):
        lo = 0
        while lo < n:
            hi = min(n, lo + max_elems - (off - start))
            chunk.append((i, lo, hi))
            off += hi - lo
            lo = hi
            if off % BLOCK == 0 and (lo == n or off - start == max_elems):
                yield start, chunk
                chunk, start = [], off
    if chunk:
        yield start, chunk


class Adam8bit(torch.optim.Optimizer):
    """Adam(lr) with int8 blockwise moment state; defaults match
    bnb.optim.Adam8bit's. The step count is shared by all parameters, as
    in the JAX state (``count``); ``code_version`` is ``STATE_FORMAT``.

    ``params`` lists the leaves: each a tensor, or a list of tensors that
    hold ONE leaf of the JAX tree between them (a stacked ``[L, ...]``
    leaf that the port keeps as L per-layer parameters). A leaf's moments
    are quantized over the concatenation of its members' flattened
    elements, so its 256-element blocks, and their scales, are the JAX
    leaf's even where a member's size is not a multiple of 256 (a norm or
    a bias). The update runs over block-aligned chunks of at most
    ``CHUNK`` elements, which bounds its temporaries (``_fma`` works in
    f64) at any parameter size.

    Over a learner mesh the members are a rank's block-aligned ranges of
    the leaf's members (``parallel/partition.py::FlatShard``), each a whole
    number of blocks: the blocks a rank holds, and their codes and scales,
    are the whole leaf's, and ``partition.gather_opt_state`` puts them back
    in a one-rank run's layout."""

    CHUNK = 1 << 22

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, clip_normalized: float = 5.0):
        self.leaves = [list(p) if isinstance(p, (list, tuple)) else [p] for p in params]
        super().__init__([t for leaf in self.leaves for t in leaf],
                         dict(lr=lr, b1=b1, b2=b2, eps=eps, clip_normalized=clip_normalized))
        if len(self.param_groups) != 1:
            raise ValueError("Adam8bit takes one parameter group")
        self.count = 0
        self.code_version = STATE_FORMAT
        for leaf in self.leaves:
            n = sum(t.numel() for t in leaf)
            zeros = torch.zeros(n, dtype=torch.float32, device=leaf[0].device)
            self.state[leaf[0]] = {"mu": _quantize(zeros), "nu": _quantize(zeros)}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam8bit takes no closure")
        self.count += 1
        group = self.param_groups[0]
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        for leaf in self.leaves:
            if any(p.grad is None for p in leaf):
                raise ValueError("Adam8bit.step needs a grad for every parameter")
            dev = leaf[0].device
            count = torch.tensor(float(self.count), dtype=torch.float32, device=dev)
            bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev), count)
            bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev), count)
            st = self.state[leaf[0]]
            for start, chunk in _pieces([p.numel() for p in leaf], self.CHUNK):
                grads = [leaf[i].grad.reshape(-1)[lo:hi] for i, lo, hi in chunk]
                g = (grads[0] if len(grads) == 1 else torch.cat(grads)).float()
                n = g.numel()
                b0, nb = start // BLOCK, -(-n // BLOCK)
                old = {m: _Quantized(st[m].q[start:start + nb * BLOCK],
                                     st[m].scale[b0:b0 + nb], n, (n,)) for m in ("mu", "nu")}
                mu = _fma(1 - b1, g, b1 * _dequantize(old["mu"]))
                nu = _fma((1 - b2) * g, g, b2 * torch.square(_dequantize(old["nu"])))
                mu_hat = mu / bc1
                nu_hat = nu / bc2
                normalized = torch.clamp(mu_hat / (torch.sqrt(nu_hat) + eps),
                                         -group["clip_normalized"], group["clip_normalized"])
                upd = -group["lr"] * normalized
                at = 0
                for i, lo, hi in chunk:
                    p = leaf[i]
                    p.view(-1)[lo:hi].add_(upd[at:at + hi - lo].to(p.dtype))
                    at += hi - lo
                for m, x in (("mu", mu), ("nu", torch.sqrt(nu))):
                    z = _quantize(x)
                    st[m].q[start:start + nb * BLOCK] = z.q
                    st[m].scale[b0:b0 + nb] = z.scale

    def state_dict(self) -> dict:
        """Tensors and numbers only, so ``torch.load(weights_only=True)``
        reads it back: per leaf (in ``params`` order) both moments' int8
        codes and block scales, the hyperparameters, the shared step count
        and the code version."""
        state = {i: {f"{m}_{f}": getattr(self.state[leaf[0]][m], f)
                     for m in ("mu", "nu") for f in ("q", "scale")}
                 for i, leaf in enumerate(self.leaves)}
        group = self.param_groups[0]
        groups = [{**{k: v for k, v in group.items() if k != "params"},
                   "params": list(range(len(group["params"])))}]
        return {"state": state, "param_groups": groups, "count": self.count,
                "code_version": self.code_version}

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore ``state_dict()``'s output onto this optimizer's leaves
        (same count, sizes and order), bit for bit."""
        if len(state_dict["state"]) != len(self.leaves) or len(
                state_dict["param_groups"]) != 1:
            raise ValueError("the saved Adam8bit state holds other parameters")
        saved_group = state_dict["param_groups"][0]
        group = self.param_groups[0]
        if len(saved_group["params"]) != len(group["params"]):
            raise ValueError("the saved Adam8bit state holds other parameter groups")
        group.update({k: v for k, v in saved_group.items() if k != "params"})
        for i, leaf in enumerate(self.leaves):
            saved, dev = state_dict["state"][i], leaf[0].device
            n = sum(p.numel() for p in leaf)
            st = {}
            for m in ("mu", "nu"):
                q, scale = saved[f"{m}_q"], saved[f"{m}_scale"]
                if q.numel() != -(-n // BLOCK) * BLOCK or q.dtype != torch.int8:
                    shapes = [tuple(p.shape) for p in leaf]
                    raise ValueError(f"saved Adam8bit state {i} does not fit the "
                                     f"parameters {shapes}")
                st[m] = _Quantized(q.to(dev), scale.to(dev, torch.float32), n, (n,))
            self.state[leaf[0]] = st
        self.count = int(state_dict["count"])
        self.code_version = int(state_dict["code_version"])


def check_state_format(optimizer) -> None:
    """Raise if a (restored) 8-bit Adam state's code version differs from
    this build's ``STATE_FORMAT``."""
    if isinstance(optimizer, Adam8bit):
        got = int(optimizer.code_version)
        if got != STATE_FORMAT:
            raise ValueError(
                f"checkpointed 8-bit Adam state is format v{got}; this build "
                f"reads v{STATE_FORMAT} — restart without resume (the moment "
                "payloads are not decodable across formats)")


def make_optimizer(params, lr: float, use_8bit: bool = True) -> torch.optim.Optimizer:
    """The learner optimizer over ``params`` (the adapter's leaves, or a
    full model's, a leaf a tensor or a list of the tensors that form one
    stacked JAX leaf): Adam(lr) with 8-bit state by default, else
    ``torch.optim.Adam(eps=1e-8)`` (the optax formula up to rounding; its
    state is elementwise, so a leaf's members are plain parameters there).
    PyTorch binds an optimizer to its parameters, so they come first here,
    unlike the JAX transform."""
    params = list(params)
    if use_8bit:
        return Adam8bit(params, lr)
    flat = [t for p in params for t in (p if isinstance(p, (list, tuple)) else [p])]
    return torch.optim.Adam(flat, lr=lr, eps=1e-8)
