"""The port stands alone and never falls back to the CPU.

* No module of ``distrl_llm_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the JAX package (an AST walk over every import).
* ``device=None`` means the GPU: without CUDA the entry points raise, and
  nothing is computed on the CPU.
* ``chip_smoke.py`` exits non-zero, printing no result, without a GPU and
  when it stands alone in a directory.
* Each kernel wrapper's ctypes signature matches its C launcher's.
"""

import ast
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "distrl_llm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "distrl_llm_tpu")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN and not m.startswith("distrl_llm_tpu_torch")]
    assert not bad, f"{path.name} imports {bad}"


def test_import_walk_sees_every_form(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom distrl_llm_tpu.ops import x\n"
                 "def g():\n    import importlib\n    importlib.import_module('flax')\n"
                 "from . import sibling\nimport distrl_llm_tpu_torch\n")
    assert sorted(_imported_modules(f)) == ["distrl_llm_tpu.ops", "distrl_llm_tpu_torch",
                                            "flax", "importlib", "jax.numpy"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_cuda):
    from distrl_llm_tpu_torch.utils.device import resolve_device

    for dev in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(dev)
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_without_cuda_raise_before_computing(no_cuda, monkeypatch):
    """Default-device calls raise before any forward or sampler runs on the
    CPU: the model's forward and the sampler are replaced by tripwires."""
    from distrl_llm_tpu_torch.engine import engine as eng
    from distrl_llm_tpu_torch.models import convert
    from distrl_llm_tpu_torch.models.configs import TINY

    def tripwire(*a, **k):
        raise AssertionError("computed on the CPU")

    monkeypatch.setattr(eng, "sample_with_logprob", tripwire)
    monkeypatch.setattr(eng, "_prefill", tripwire)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.GenerationEngine(TINY, max_prompt_tokens=8, max_new_tokens=4,
                             eos_token_ids=[3], pad_token_id=0)
    tree = {"embed": np.zeros((TINY.vocab_size, TINY.hidden_size), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy(tree, TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lora_from_numpy({"layers": {}}, TINY)


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_without_gpu_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs for real there")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# (csrc source, wrapper module, C functions declared by its _kernel_lib)
LAUNCHERS = (
    ("fused_sample", "sampling", ("fused_sample_launch", "fused_sample_max_active_clusters")),
    ("paged_attention", "paged_native", ("paged_attention_launch",)),
    ("flash_attention", "flash_attention", ("flash_attention_fwd", "flash_attention_bwd")),
    ("quant_matmul", "quant_matmul", ("quant_matmul_launch",)),
    ("paged_verify", "paged_native", ("paged_verify_launch",)),
)


@pytest.mark.parametrize("source,module,functions", LAUNCHERS, ids=[x[0] for x in LAUNCHERS])
def test_kernel_wrapper_signature_matches_the_c_launcher(monkeypatch, source, module, functions):
    """Every pointer crosses ctypes as c_void_p (a default int would cut it
    to 32 bits), a float as c_float, and the argument count matches the C
    declaration."""
    import importlib

    from distrl_llm_tpu_torch.ops import _build

    src = (PORT / "csrc" / f"{source}.cu").read_text()

    class Fn:
        argtypes = None
        restype = None

    names = list(functions) + [f"{source}_error_string"]
    lib = type("Lib", (), {n: Fn() for n in names})()
    monkeypatch.setattr(_build, "load", lambda name: type("B", (), {"lib": lib}))
    wrapper = importlib.import_module(f"distrl_llm_tpu_torch.ops.{module}")
    # the module's loader of this source (paged_native holds K2's and K5's)
    loader = wrapper._verify_lib if source == "paged_verify" else wrapper._kernel_lib
    clear = getattr(loader, "cache_clear", lambda: None)  # lru-cached ones
    clear()
    try:
        declared = loader()
    finally:
        clear()
    for fn in functions:
        decl = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
        params = [p.strip() for p in decl.split(",")]
        got = getattr(declared, fn).argtypes
        assert len(got) == len(params), fn
        for c_param, ct in zip(params, got):
            want = (ctypes.c_void_p if "*" in c_param
                    else ctypes.c_float if c_param.startswith("float") else ctypes.c_int)
            assert ct is want, (fn, c_param)
