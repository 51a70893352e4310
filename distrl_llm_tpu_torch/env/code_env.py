"""The sandboxed code-execution tool environment (the JAX package's
``env/code_env.py``).

The model writes ``<tool>...</tool>`` blocks of Python; the environment runs
the last block in a restricted subprocess and feeds its captured output back
as the next turn's observation (in ``<output>`` tags, loss-masked by the
driver). The episode ends when the model commits to an ``<answer>`` or the
turns run out; accuracy is then scored as the math task scores it.

The sandbox (the standard library only):

* interpreter isolation: ``python -I`` (no environment variables, no user
  site, no working directory on ``sys.path``), an empty environment, the
  temporary directory as working directory;
* resource limits: CPU seconds, address space, file size and process count,
  and a wall-clock timeout that kills the child;
* the output cut to ``output_limit`` characters before it is tokenized.

The JAX package sets the limits in a ``preexec_fn``, which Python documents
as unsafe while other threads run: the child of a fork may wait forever on a
lock a thread of the parent held at the fork, and under the overlapped
rollout modes the rollout thread runs beside the learner's. Here the child
sets them itself: ``python -I`` runs a short prelude that sets the limits and
then replaces itself (``os.execv``, the same process, so the limits hold)
with ``python -I -c <code>``. The code runs exactly as it would have, so the
captured output is the JAX function's, character for character.

This guards against accidents (endless loops, fork bombs, giant prints) in
the rollouts of a policy under training, not against an adversary.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from typing import Any

from distrl_llm_tpu_torch.env.base import EnvStep
from distrl_llm_tpu_torch.rewards import correctness_reward, make_format_scorer

_TOOL_RE = re.compile(r"<tool>(.*?)</tool>", re.DOTALL)

_CPU_SECONDS = 2
_ADDRESS_SPACE = 512 << 20  # 512 MiB
_FILE_SIZE = 1 << 20  # 1 MiB
_MAX_PROCS = 16
# the prelude's exit code when a limit the sandbox needs cannot be set (the
# JAX package's preexec_fn raises there: subprocess's SubprocessError)
_SETUP_FAILED = 125

_PRELUDE = f"""\
import os, resource, sys
try:
    resource.setrlimit(resource.RLIMIT_CPU, ({_CPU_SECONDS}, {_CPU_SECONDS}))
    resource.setrlimit(resource.RLIMIT_FSIZE, ({_FILE_SIZE}, {_FILE_SIZE}))
except (ValueError, OSError):
    os._exit({_SETUP_FAILED})
for name, value in (("RLIMIT_AS", {_ADDRESS_SPACE}), ("RLIMIT_NPROC", {_MAX_PROCS})):
    limit = getattr(resource, name, None)
    if limit is None:
        continue
    try:
        resource.setrlimit(limit, (value, value))
    except (ValueError, OSError):
        pass  # some kernels or users refuse; the wall timeout still holds
os.execv(sys.executable, [sys.executable, "-I", "-c", sys.argv[1]])
"""


def run_sandboxed(code: str, timeout_s: float = 5.0, output_limit: int = 256) -> str:
    """Run ``code`` in the restricted subprocess; return its (cut) output."""
    try:
        proc = subprocess.run(
            [sys.executable, "-I", "-c", _PRELUDE, code],
            capture_output=True,
            text=True,
            timeout=timeout_s,
            env={},
            cwd=tempfile.gettempdir(),
        )
        if proc.returncode == _SETUP_FAILED and not proc.stdout and not proc.stderr:
            out = "<tool error: SubprocessError>"
        else:
            out = proc.stdout if proc.returncode == 0 else proc.stdout + proc.stderr
    except subprocess.TimeoutExpired:
        out = "<tool timeout>"
    except Exception as exc:  # sandbox setup failure, not model output
        out = f"<tool error: {type(exc).__name__}>"
    out = out.strip()
    if not out:
        return "<no output>"
    return out[:output_limit]


class CodeToolEnv:
    """Multi-turn tool environment: run ``<tool>`` blocks, return the output."""

    name = "code"

    def __init__(self, format_scorer: str = "soft", max_turns: int = 4,
                 tool_timeout_s: float = 5.0, output_limit: int = 256):
        self.max_turns = max(1, int(max_turns))
        self.tool_timeout_s = float(tool_timeout_s)
        self.output_limit = int(output_limit)
        self._fmt = make_format_scorer(format_scorer)
        self._task: dict[str, Any] | None = None
        self._turn = 0
        self._tool_seq = 0

    def reset(self, task: dict[str, Any]) -> str:
        self._task = dict(task)
        self._turn = 0
        self._tool_seq = 0
        return str(task.get("problem", ""))

    def _terminal(self, completion: str, fmt: float) -> EnvStep:
        assert self._task is not None
        acc = float(correctness_reward([completion], [str(self._task.get("solution", ""))])[0])
        return EnvStep(None, fmt, True, {"accuracy": acc})

    def step(self, completion: str) -> EnvStep:
        if self._task is None:
            raise RuntimeError("step() before reset()")
        self._turn += 1
        fmt = float(self._fmt([completion])[0])
        if "<answer>" in completion or self._turn >= self.max_turns:
            return self._terminal(completion, fmt)
        blocks = _TOOL_RE.findall(completion)
        if blocks:
            self._tool_seq += 1
            tool_call_id = f"tool-{self._tool_seq}"
            out = run_sandboxed(blocks[-1], self.tool_timeout_s, self.output_limit)
            obs = f"\n<output>\n{out}\n</output>\n"
            # a small bonus for a well-formed tool call: shaped, not accuracy
            return EnvStep(obs, fmt + 0.05, False,
                           {"tool_call_id": tool_call_id, "tool_output": out})
        obs = ("\nNo <answer> given. Use <tool>...</tool> to compute, then reply in "
               "<answer>...</answer> tags.\n")
        return EnvStep(obs, fmt, False, {})
