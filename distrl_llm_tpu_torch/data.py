"""Dataset preparation, R1-style prompting and the trainer's dataset.

Host code copied from the JAX package's ``data.py`` (the port imports nothing
of that package): system+user chat template with ``add_generation_prompt``,
over any tokenizer with a chat template, with a plain ChatML fallback for
template-less test tokenizers; the MATH-500 and GSM8K preparers (through the
``datasets`` package, imported only when they run); and ``DictDataset``, the
dict-of-lists dataset the trainer iterates, whose seeded shuffle gives the
JAX package's order (the resume cursor depends on it).
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping, Sequence

import numpy as np

# Reference system prompt, verbatim contract.
R1_PREPROMPT = (
    "A conversation between User and Assistant. The user asks a question, and the Assistant solves it.\n"
    "The assistant first thinks about the reasoning process and then provides the user with the answer.\n"
    "The response must follow this format:\n"
    "<think> reasoning process here </think>\n"
    "<answer> answer here </answer>\n"
)

_FALLBACK_TEMPLATE = (
    "{% for message in messages %}"
    "<|im_start|>{{ message['role'] }}\n{{ message['content'] }}<|im_end|>\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
)


def build_chat_prompt(tokenizer, problem: str, preprompt: str = "", postprompt: str = "") -> str:
    """One problem → chat-templated prompt string (system = preprompt,
    user = problem + ' ' + postprompt, generation prompt appended)."""
    messages = [
        {"role": "system", "content": preprompt},
        {"role": "user", "content": problem + " " + postprompt},
    ]
    kwargs = {}
    # template-less tokenizers get a ChatML-style fallback passed per call
    if getattr(tokenizer, "chat_template", None) is None:
        kwargs["chat_template"] = _FALLBACK_TEMPLATE
    return tokenizer.apply_chat_template(
        messages, add_generation_prompt=True, tokenize=False, **kwargs
    )


def process_dataset(tokenizer, dataset, preprompt: str = "", postprompt: str = ""):
    """Map the ``problem`` column through the chat template. Accepts an HF
    ``datasets.Dataset`` (uses .map) or a plain dict-of-lists (returns a new
    dict)."""

    def _map(examples: Mapping[str, Sequence[str]]) -> dict[str, list[str]]:
        return {
            "problem": [
                build_chat_prompt(tokenizer, p, preprompt, postprompt)
                for p in examples["problem"]
            ]
        }

    if hasattr(dataset, "map"):
        return dataset.map(_map, batched=True)
    out = dict(dataset)
    out.update(_map(dataset))
    return out


def prepare_math500(dataset_name: str, tokenizer, test_size: float = 0.1,
                    seed: int | None = None):
    """Load, split and template MATH-500 as the reference CLI does
    (train_distributed.py:38-48): the 'test' split, answer -> solution,
    train_test_split(test_size), chat templating on both splits."""
    from datasets import load_dataset  # deferred: heavy, and only this path needs it

    raw = load_dataset(dataset_name)["test"]
    raw = raw.map(lambda x: {"solution": x["answer"]})
    raw = raw.remove_columns(["answer"])
    split = raw.train_test_split(test_size=test_size, seed=seed)
    train = process_dataset(tokenizer, split["train"], R1_PREPROMPT, "")
    test = process_dataset(tokenizer, split["test"], R1_PREPROMPT, "")
    return train, test


def extract_gsm8k_solution(answer: str) -> str:
    """GSM8K gold answers end with ``#### <number>``: the graded solution is
    that number without thousands separators."""
    tail = answer.rsplit("####", 1)[-1] if "####" in answer else answer
    return tail.strip().replace(",", "").replace("$", "")


def prepare_gsm8k(dataset_name: str, tokenizer, test_size: float = 0.1,
                  seed: int | None = None):
    """Load and template GSM8K: RL trains on its train split and evaluates
    on its test split (``test_size`` is unused; kept for the dispatcher's
    uniform signature)."""
    from datasets import load_dataset

    raw = load_dataset(dataset_name, "main")

    def remap(ds):
        ds = ds.map(lambda x: {"problem": x["question"],
                               "solution": extract_gsm8k_solution(x["answer"])})
        return ds.remove_columns([c for c in ("question", "answer") if c in ds.column_names])

    train = process_dataset(tokenizer, remap(raw["train"]), R1_PREPROMPT, "")
    test = process_dataset(tokenizer, remap(raw["test"]), R1_PREPROMPT, "")
    return train, test


def prepare_dataset(dataset_name: str, tokenizer, test_size: float = 0.1,
                    seed: int | None = None):
    """Dispatch on the dataset id: GSM8K-style or MATH-500-style."""
    if "gsm8k" in dataset_name.lower():
        return prepare_gsm8k(dataset_name, tokenizer, test_size, seed)
    return prepare_math500(dataset_name, tokenizer, test_size, seed)


class DictDataset:
    """Dict-of-lists dataset with the iteration surface the trainer uses
    (``shuffle(seed)`` and ``iter(batch_size)``, distributed_trainer.py:245-246)."""

    def __init__(self, data: Mapping[str, Sequence[Any]], seed: int | None = None):
        lengths = {k: len(v) for k, v in data.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"ragged columns: {lengths}")
        self.data = {k: list(v) for k, v in data.items()}
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(next(iter(self.data.values()), []))

    def __getitem__(self, key: str) -> list[Any]:
        return self.data[key]

    def shuffle(self, seed: int | None = None) -> "DictDataset":
        """Seedable like HF ``Dataset.shuffle(seed=...)``: the permutation is
        numpy's ``default_rng(seed).permutation``, as in the JAX package, so
        both packages (and a resumed run) see one batch order."""
        rng = np.random.default_rng(seed) if seed is not None else self._rng
        perm = rng.permutation(len(self))
        out = DictDataset({k: [v[i] for i in perm] for k, v in self.data.items()})
        out._rng = self._rng
        return out

    def iter(self, batch_size: int) -> Iterator[dict[str, list[Any]]]:
        for start in range(0, len(self), batch_size):
            yield {k: v[start:start + batch_size] for k, v in self.data.items()}

    @staticmethod
    def wrap(dataset) -> "DictDataset | Any":
        """Pass datasets with ``iter`` and ``shuffle`` (HF) through; wrap
        mappings."""
        if hasattr(dataset, "iter") and hasattr(dataset, "shuffle"):
            return dataset
        return DictDataset(dataset)
